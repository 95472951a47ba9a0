"""k2_roofline.batch: K2 (flash decode): least time from the shapes over device time, %."""
from pbench import readers

read = readers.roofline("k2")
