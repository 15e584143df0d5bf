"""Rate of the reads' batch pulls, in 10^9 bytes a second: the bytes the
port's ``exec.pull`` spans under its ``session.query`` spans copied off the
device, over those spans' time, in the traced pass (``mvbench/spans.py``).
A traced pull span opens once the device has run the read's blocks, so it
times the copies.  Nothing where no pull copied off a CUDA device."""
from mvbench.spans import totals


def read(ctx):
    t = totals("session.query")
    pull = (t or {}).get("exec.pull", {})
    if not pull.get("bytes") or not pull.get("s"):
        return None
    return pull["bytes"] / pull["s"] / 1e9
