"""perm_roofline.build: the least time of the traced trees' permutations over the device time of the package's permutation kernels, in %."""

from hbench import readers

read = readers.perm_roofline
