"""host_launches_per_proof: the host's kernel and graph launch calls a proof."""

from hbench import readers

read = readers.launches_per_work
