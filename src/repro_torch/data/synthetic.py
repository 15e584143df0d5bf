"""Synthetic property graphs shaped like the paper's datasets.

* :func:`snb_like` — LDBC SNB-flavoured social network: Persons (knows,
  livesIn), Forums/Posts, Comments forming replyOf trees rooted at Posts,
  Tags.  The reply trees are acyclic on replyOf — the regime where the
  paper's views shine (ROOT_POST etc.) and walk ≡ trail semantics.
* :func:`finbench_like` — LDBC FinBench-flavoured: Accounts (transfer),
  Persons/Companies (own, apply, guarantee), Loans (deposit).

Sizes are parameterized (defaults ~10^4 nodes) and preserve the shape:
power-law reply trees, clustered transfer rings.  The numpy RNG stream is
the reference's, so the same seed builds the same graph in both packages.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from repro_torch.core.graph import GraphBuilder, PropertyGraph
from repro_torch.core.schema import GraphSchema
from repro_torch.utils.device import DeviceLike


def snb_like(seed: int = 0, n_person: int = 2000, n_post: int = 1500,
             n_comment: int = 12000, n_place: int = 60, n_tag: int = 300,
             knows_deg: float = 6.0, slack: float = 4.0,
             device: DeviceLike = None
             ) -> Tuple[PropertyGraph, GraphSchema, dict]:
    rng = np.random.default_rng(seed)
    schema = GraphSchema()
    b = GraphBuilder(schema)
    persons = [b.add_node("Person") for _ in range(n_person)]
    places = [b.add_node("Place") for _ in range(n_place)]
    posts = [b.add_node("Post") for _ in range(n_post)]
    tags = [b.add_node("Tag") for _ in range(n_tag)]
    comments = [b.add_node("Comment") for _ in range(n_comment)]

    # knows: preferential-attachment-ish directed social graph
    n_knows = int(n_person * knows_deg)
    src = rng.integers(0, n_person, n_knows)
    dst = (src + rng.zipf(2.0, n_knows)) % n_person
    for u, v in zip(src, dst):
        if u != v:
            b.add_edge(persons[u], persons[v], "knows")
    for p in persons:
        b.add_edge(p, places[rng.integers(n_place)], "livesIn")
    for po in posts:
        b.add_edge(po, tags[rng.integers(n_tag)], "hasTag")
        b.add_edge(persons[rng.integers(n_person)], po, "created")
    # reply trees: each comment replies to a post (root) or an earlier comment
    for i, c in enumerate(comments):
        if i == 0 or rng.random() < 0.35:
            b.add_edge(c, posts[rng.integers(n_post)], "replyOf")
        else:
            b.add_edge(c, comments[rng.integers(i)], "replyOf")
        b.add_edge(persons[rng.integers(n_person)], c, "created")
        if rng.random() < 0.3:
            b.add_edge(c, tags[rng.integers(n_tag)], "hasTag")
    g = b.finalize(slack=slack, device=device)
    ids = {"persons": persons, "places": places, "posts": posts,
           "tags": tags, "comments": comments}
    return g, schema, ids


def finbench_like(seed: int = 0, n_account: int = 4000, n_person: int = 1500,
                  n_company: int = 500, n_loan: int = 800,
                  transfer_deg: float = 5.0, slack: float = 4.0,
                  device: DeviceLike = None
                  ) -> Tuple[PropertyGraph, GraphSchema, dict]:
    rng = np.random.default_rng(seed)
    schema = GraphSchema()
    b = GraphBuilder(schema)
    accounts = [b.add_node("Account") for _ in range(n_account)]
    persons = [b.add_node("Person") for _ in range(n_person)]
    companies = [b.add_node("Company") for _ in range(n_company)]
    loans = [b.add_node("Loan") for _ in range(n_loan)]

    n_tr = int(n_account * transfer_deg)
    src = rng.integers(0, n_account, n_tr)
    dst = (src + 1 + rng.zipf(1.8, n_tr)) % n_account
    for u, v in zip(src, dst):
        if u != v:
            b.add_edge(accounts[u], accounts[v], "transfer")
    for p in persons:
        b.add_edge(p, accounts[rng.integers(n_account)], "own")
        if rng.random() < 0.4:
            b.add_edge(p, companies[rng.integers(n_company)], "workIn")
    for c in companies:
        b.add_edge(c, accounts[rng.integers(n_account)], "own")
    for ln in loans:
        b.add_edge(persons[rng.integers(n_person)]
                   if rng.random() < 0.7
                   else companies[rng.integers(n_company)], ln, "apply")
        b.add_edge(ln, accounts[rng.integers(n_account)], "deposit")
    for _ in range(n_person // 3):
        a, c = rng.integers(n_person), rng.integers(n_company)
        b.add_edge(persons[a], companies[c], "guarantee")
    g = b.finalize(slack=slack, device=device)
    ids = {"accounts": accounts, "persons": persons,
           "companies": companies, "loans": loans}
    return g, schema, ids

