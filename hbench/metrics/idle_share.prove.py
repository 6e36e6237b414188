"""idle_share.prove: 1 - the device busy time a traced proof step over the untraced window's host time a step."""

from hbench import readers

read = readers.idle_share
