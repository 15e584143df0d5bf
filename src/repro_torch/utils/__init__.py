from repro_torch.utils.device import host, resolve_device
from repro_torch.utils.misc import INF_HOPS, cdiv, pad_to, round_up

__all__ = ["round_up", "pad_to", "INF_HOPS", "cdiv", "host", "resolve_device"]
