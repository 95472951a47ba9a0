"""mfu.batch: Useful operations of the traced window over its seconds and the bf16 peak, %."""
from pbench import readers

read = readers.mfu()
