"""device_idle.batch: % of the traced window with no kernel or copy on the device."""
from pbench import readers

read = readers.device_idle()
