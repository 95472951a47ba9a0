"""prefill_ms.batch: Wall ms of one Endpoint.prefill_batch, either tier."""
from pbench import readers

read = readers.mean_span_ms("prefill_batch")
