"""tick_overhead_ms.batch: Host ms of a Continuum.tick outside decode_all, prefill_batch and controller_update."""
from pbench import readers

read = readers.tick_overhead_ms()
