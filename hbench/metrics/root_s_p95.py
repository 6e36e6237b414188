"""root_s_p95: the 95th percentile, over every tree of the window, of the seconds from the call to its root on the host."""

from hbench import readers

read = readers.p95_s
