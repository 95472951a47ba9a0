"""decode_step_ms.batch: Wall ms of one Endpoint.decode_all, either tier."""
from pbench import readers

read = readers.mean_span_ms("decode_all")
