"""moe_expert_ms.batch: Device ms of the routed expert products per decode step."""
from pbench import readers

read = readers.moe_expert_ms()
