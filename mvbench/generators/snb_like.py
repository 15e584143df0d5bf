"""SNB-shaped social graph, vectorised.

Frozen copy of the distributions of ``repro_torch/data/synthetic.py::
snb_like`` (at commit a5f2a9c): Persons that ``knows`` each other with
zipf(2.0) offsets, one ``livesIn`` Place each, Posts with one ``hasTag``
and one ``created`` author, Comments whose ``replyOf`` edge points at a
Post (35%) or at an earlier Comment (so reply trees are acyclic), each
with an author and a Tag 30% of the time.  The draws are vectorised, so
the stream differs from the original's: the same seed gives the same
graph here, not the original's graph.
"""
from __future__ import annotations

import numpy as np

NODE_LABELS = ("Person", "Place", "Post", "Tag", "Comment")
EDGE_LABELS = ("knows", "livesIn", "hasTag", "created", "replyOf")


def generate(rng: np.random.Generator, sizes: dict) -> dict:
    n_person, n_place = int(sizes["n_person"]), int(sizes["n_place"])
    n_post, n_tag = int(sizes["n_post"]), int(sizes["n_tag"])
    n_comment = int(sizes["n_comment"])
    counts = (n_person, n_place, n_post, n_tag, n_comment)
    first = np.concatenate([[0], np.cumsum(counts)[:-1]])
    person0, place0, post0, tag0, comment0 = (int(f) for f in first)
    node_label = np.repeat(np.arange(len(counts), dtype=np.int32), counts)

    src, dst, lab = [], [], []

    def add(s, d, name):
        src.append(np.asarray(s, np.int64))
        dst.append(np.asarray(d, np.int64))
        lab.append(np.full(len(src[-1]), EDGE_LABELS.index(name), np.int32))

    n_knows = int(n_person * float(sizes["knows_deg"]))
    ks = rng.integers(0, n_person, n_knows)
    kd = (ks + rng.zipf(2.0, n_knows)) % n_person
    keep = ks != kd
    add(person0 + ks[keep], person0 + kd[keep], "knows")
    add(person0 + np.arange(n_person),
        place0 + rng.integers(0, n_place, n_person), "livesIn")
    posts = post0 + np.arange(n_post)
    add(posts, tag0 + rng.integers(0, n_tag, n_post), "hasTag")
    add(person0 + rng.integers(0, n_person, n_post), posts, "created")
    i = np.arange(n_comment)
    to_post = (i == 0) | (rng.random(n_comment) < 0.35)
    earlier = np.floor(rng.random(n_comment) * i).astype(np.int64)
    target = np.where(to_post, post0 + rng.integers(0, n_post, n_comment),
                      comment0 + earlier)
    comments = comment0 + i
    add(comments, target, "replyOf")
    add(person0 + rng.integers(0, n_person, n_comment), comments, "created")
    tagged = rng.random(n_comment) < 0.3
    add(comments[tagged], tag0 + rng.integers(0, n_tag, int(tagged.sum())),
        "hasTag")
    return {"node_labels": NODE_LABELS, "node_label": node_label,
            "edge_labels": EDGE_LABELS, "src": np.concatenate(src),
            "dst": np.concatenate(dst), "edge_label": np.concatenate(lab)}
