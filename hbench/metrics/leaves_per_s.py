"""leaves_per_s: leaves hashed into roots read back on the host, a second, over the whole window."""

from hbench import readers

read = readers.rate
