"""host_launches_per_batch.openings: the host's kernel and graph launch calls an opening batch."""

from hbench import readers

read = readers.launches_per_step
