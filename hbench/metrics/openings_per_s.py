"""openings_per_s: openings opened and given a verdict on the host, a second, over the whole window."""

from hbench import readers

read = readers.rate
