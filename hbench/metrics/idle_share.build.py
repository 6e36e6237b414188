"""idle_share.build: 1 - the device busy time a traced tree over the untraced window's host time a tree."""

from hbench import readers

read = readers.idle_share
