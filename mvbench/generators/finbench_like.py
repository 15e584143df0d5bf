"""FinBench-shaped financial graph, vectorised.

Frozen copy of the distributions of ``repro_torch/data/synthetic.py::
finbench_like`` (at commit a5f2a9c): Accounts that ``transfer`` to each
other with 1 + zipf(1.8) offsets (clustered rings), Persons and Companies
that ``own`` one Account each, Persons that ``workIn`` a Company (40%),
Loans that a Person (70%) or a Company ``apply`` for and that ``deposit``
into an Account, and Persons that ``guarantee`` Companies.  The draws are
vectorised, so the stream differs from the original's.
"""
from __future__ import annotations

import numpy as np

NODE_LABELS = ("Account", "Person", "Company", "Loan")
EDGE_LABELS = ("transfer", "own", "workIn", "apply", "deposit", "guarantee")


def generate(rng: np.random.Generator, sizes: dict) -> dict:
    n_account, n_person = int(sizes["n_account"]), int(sizes["n_person"])
    n_company, n_loan = int(sizes["n_company"]), int(sizes["n_loan"])
    counts = (n_account, n_person, n_company, n_loan)
    first = np.concatenate([[0], np.cumsum(counts)[:-1]])
    account0, person0, company0, loan0 = (int(f) for f in first)
    node_label = np.repeat(np.arange(len(counts), dtype=np.int32), counts)

    src, dst, lab = [], [], []

    def add(s, d, name):
        src.append(np.asarray(s, np.int64))
        dst.append(np.asarray(d, np.int64))
        lab.append(np.full(len(src[-1]), EDGE_LABELS.index(name), np.int32))

    n_tr = int(n_account * float(sizes["transfer_deg"]))
    ts = rng.integers(0, n_account, n_tr)
    td = (ts + 1 + rng.zipf(1.8, n_tr)) % n_account
    keep = ts != td
    add(account0 + ts[keep], account0 + td[keep], "transfer")
    persons = person0 + np.arange(n_person)
    add(persons, account0 + rng.integers(0, n_account, n_person), "own")
    works = rng.random(n_person) < 0.4
    add(persons[works],
        company0 + rng.integers(0, n_company, int(works.sum())), "workIn")
    add(company0 + np.arange(n_company),
        account0 + rng.integers(0, n_account, n_company), "own")
    loans = loan0 + np.arange(n_loan)
    by_person = rng.random(n_loan) < 0.7
    applicant = np.where(by_person,
                         person0 + rng.integers(0, n_person, n_loan),
                         company0 + rng.integers(0, n_company, n_loan))
    add(applicant, loans, "apply")
    add(loans, account0 + rng.integers(0, n_account, n_loan), "deposit")
    n_g = n_person // 3
    add(person0 + rng.integers(0, n_person, n_g),
        company0 + rng.integers(0, n_company, n_g), "guarantee")
    return {"node_labels": NODE_LABELS, "node_label": node_label,
            "edge_labels": EDGE_LABELS, "src": np.concatenate(src),
            "dst": np.concatenate(dst), "edge_label": np.concatenate(lab)}
