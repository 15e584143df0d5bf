"""Device-to-host pulls (``repro_torch.utils.device.host.calls`` plus
``host_flag.calls``) over the window, per read."""


def read(ctx):
    lay = ctx["layer"]
    if not lay.get("reads"):
        return None
    return lay["pulls"] / lay["reads"]
