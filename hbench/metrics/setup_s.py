"""setup_s: seconds from the start of the process to the first timed step (imports, library load, inputs made on the card, keys, warm-up)."""

from hbench import readers

read = readers.setup
