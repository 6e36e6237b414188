"""device_ms_per_proof: device busy ms (the union of the device's operations) a proof."""

from hbench import readers

read = readers.device_ms_per_work
