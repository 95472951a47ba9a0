"""k1_roofline.batch: K1 (flash prefill): least time from the shapes over device time, %."""
from pbench import readers

read = readers.roofline("k1")
