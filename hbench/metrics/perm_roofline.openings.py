"""perm_roofline.openings: the least time of the traced batches' verification permutations over the device time of the package's permutation kernels, in %."""

from hbench import readers

read = readers.perm_roofline
