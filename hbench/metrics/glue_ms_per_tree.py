"""glue_ms_per_tree: device ms a tree in operations that are not the package's own kernels (the drivers' plain-torch glue, copies)."""

from hbench import readers

read = readers.glue_ms_per_step
