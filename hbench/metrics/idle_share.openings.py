"""idle_share.openings: 1 - the device busy time a traced batch of openings over the untraced window's host time a batch."""

from hbench import readers

read = readers.idle_share
