"""proofs_per_s: proofs completed on the host, a second, over the whole window."""

from hbench import readers

read = readers.rate
