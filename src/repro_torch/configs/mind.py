"""mind: embed_dim=64 n_interests=4 capsule_iters=3 multi-interest retrieval
[arXiv:1904.08030; unverified].

The user->item interaction graph is a property graph; the retrieval
co-occurrence view (item <- user -> item) is materialized and incrementally
maintained by the MV4PG engine as streaming interactions arrive — see
examples/graph_views_demo.py."""
from repro_torch.configs.base import ArchSpec
from repro_torch.models.recsys.mind import MINDConfig


def full() -> MINDConfig:
    return MINDConfig(name="mind", n_items=1_000_000, embed_dim=64,
                      n_interests=4, capsule_iters=3, hist_len=50)


def smoke() -> MINDConfig:
    return MINDConfig(name="mind-smoke", n_items=1_000, embed_dim=16,
                      n_interests=4, capsule_iters=3, hist_len=10)


SPEC = ArchSpec(arch_id="mind", family="recsys", model="mind",
                full=full, smoke=smoke, source="arXiv:1904.08030")
