"""Port front end (parser, fingerprint, matcher, optimizer) == reference.

The same query and view texts go through ``repro`` and ``repro_torch``;
parsed patterns, ``pretty()`` renderings, fingerprints, view matches and
Algorithm-3 rewrites must agree exactly.  Objects of the two packages are
compared through :func:`plain`, which strips them to builtin tuples.
"""
import dataclasses
import enum
from types import SimpleNamespace

import pytest

import repro.core.matcher as r_matcher
import repro.core.optimizer as r_opt
import repro.core.parser as r_parser
import repro.core.schema as r_schema
import repro_torch.core.matcher as p_matcher
import repro_torch.core.optimizer as p_opt
import repro_torch.core.parser as p_parser
import repro_torch.core.schema as p_schema

REF = SimpleNamespace(parser=r_parser, matcher=r_matcher, opt=r_opt,
                      schema=r_schema)
PORT = SimpleNamespace(parser=p_parser, matcher=p_matcher, opt=p_opt,
                       schema=p_schema)


def plain(x):
    """Package-independent structure: dataclasses -> (name, fields...),
    enums -> value, sequences -> tuples."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,) + tuple(
            plain(getattr(x, f.name)) for f in dataclasses.fields(x))
    if isinstance(x, enum.Enum):
        return x.value
    if isinstance(x, (tuple, list)):
        return tuple(plain(v) for v in x)
    if isinstance(x, dict):
        return tuple(sorted((k, plain(v)) for k, v in x.items()))
    return x


QUERIES = [
    "MATCH (n:Comment)-[r:replyOf*..]->(m:Post) RETURN n, m",
    "MATCH (a)-[:x*]->(b) RETURN a",
    "MATCH (a)-[:x*3]->(b) RETURN a",
    "MATCH (a)-[:x*3..]->(b) RETURN a",
    "MATCH (a)-[:x*..4]->(b) RETURN a",
    "MATCH (a)-[:x*2..5]->(b) RETURN a",
    "MATCH (a:P {id: 7})<-[:x]-(b)-[:y*1..2]-(c) RETURN c",
    "MATCH (a)-[:x]->(b) RETURN count(*)",
    "MATCH (a:A)-[:x*2..3]->(b:B)-[:y]->(c:C) RETURN a, c",
    "match (n:A)-[r:x]->(m:B) return n, m",
    "Match (a)-[:x]->(b) Return count(*)",
    "match (n:person)-[:KNOWS]->(m) return n",
    "MATCH (a:A)-[e:x {w: 3}]->(b) RETURN a, b",
    "MATCH (a)-[e:x {w: 3, k: 1}]->(b) RETURN a",
    "MATCH (n:A {id: 5, age: 30})-[:x]->(m) RETURN n",
    "MATCH (n:A)-[r:x]->(m:B) WHERE n.age > 30 AND r.w <= 5 AND m.age >= 1 "
    "RETURN n, m",
    "MATCH (n:A)-[r:x]->(m:B) WHERE m.age = 2 RETURN n",
    "MATCH (n:A) WHERE n.id = 5 RETURN n",
    "MATCH (n:A)-[e:x*1..3]->(m:B) WHERE n.age >= 3 AND e.w < 5 RETURN n, m",
    "MATCH (a:Person)-[:knows]->(m:Person)-[:knows]->(b:Person)"
    "-[:livesIn]->(c:Place) RETURN a, c",
    "MATCH (b:Person)<-[:knows*2..3]-(a:Person) RETURN a, b",
    "MATCH (s:A)-[e:x]->(m:B)-[f:x]->(d) WHERE e.w >= 2 RETURN s, d",
    "MATCH (p:Post)<-[:replyOf*..]-(c:Comment) RETURN p, c",
]

VIEWS = [
    """CREATE VIEW ROOT_POST AS (
        CONSTRUCT (c)-[r:ROOT_POST]->(p)
        MATCH (c:Comment)-[:replyOf*..]->(p:Post))""",
    """CREATE VIEW R AS (
        CONSTRUCT (p)-[r:R]->(c)
        MATCH (c:Comment)-[:replyOf*..]->(p:Post))""",
    "create view V1 as (construct (s)-[r:V1]->(d) match (s:A)-[:x]->(d:B))",
    "CREATE VIEW VP AS (CONSTRUCT (s)-[r:VP]->(d) "
    "MATCH (s:A)-[e:x]->(d:B) WHERE e.w >= 2 AND s.age < 9)",
    "CREATE VIEW RV AS (CONSTRUCT (s)-[r:RV]->(d) MATCH (s:A)-[:x]->(d:B))"
    " REFRESH DEFERRED",
    "CREATE VIEW RV AS (CONSTRUCT (s)-[r:RV]->(d) MATCH (s:A)-[:x]->(d:B))"
    " refresh staleness 5",
    """CREATE VIEW VK AS (
        CONSTRUCT (s)-[r:VK]->(d) MATCH (s:Person)-[:knows*2..3]->(d:Person))""",
    """CREATE VIEW TWOHOP AS (
        CONSTRUCT (s)-[r:TWOHOP]->(d)
        MATCH (s:Person)-[:knows]->(m:Person)-[:knows]->(d:Person))""",
]

BAD_QUERIES = [
    "MATCH (a-[:x]->(b) RETURN a",
    "MATCH (a)-[:x*5..2]->(b) RETURN a",
    "MATCH (a)-[:x]->(b) WHERE q.w > 3 RETURN a",
    "MATCH (a)-[:x]->(b) WHERE a.w ! 3 RETURN a",
    "MATCH (a {id > 3})-[:x]->(b) RETURN a",
    "MATCH (a)-[:x]->(b) WHERE a.id >= 3 RETURN a",
]
BAD_VIEWS = [
    "CREATE VIEW V AS (CONSTRUCT (a)-[r:W]->(b) MATCH (a)-[:x]->(b))",
    "CREATE VIEW RV AS (CONSTRUCT (s)-[r:RV]->(d) MATCH (s:A)-[:x]->(d:B))"
    " REFRESH SOMETIMES",
    "CREATE VIEW RV AS (CONSTRUCT (s)-[r:RV]->(d) MATCH (s:A)-[:x]->(d:B))"
    " REFRESH STALENESS 0",
]


def _schema(pkg):
    s = pkg.schema.GraphSchema()
    for lb in ("A", "B", "C", "P", "Person", "Place", "Comment", "Post"):
        s.node_labels.intern(lb)
    for lb in ("x", "y", "knows", "livesIn", "replyOf"):
        s.edge_labels.intern(lb)
    return s


@pytest.mark.parametrize("text", QUERIES)
def test_parse_canonicalize_fingerprint_match(text):
    qr = r_parser.parse_query(text)
    qp = p_parser.parse_query(text)
    assert plain(qp) == plain(qr)
    assert qp.pretty() == qr.pretty()
    assert plain(p_parser.parse_query(qp.pretty()).path) == \
        plain(r_parser.parse_query(qr.pretty()).path)
    cr, fr = r_parser.canonicalize_query(qr, _schema(REF))
    cp, fp = p_parser.canonicalize_query(qp, _schema(PORT))
    assert plain(cp) == plain(cr)
    assert plain(fp) == plain(fr)


@pytest.mark.parametrize("text", VIEWS)
def test_parse_view_matches(text):
    vr, vp = r_parser.parse_view(text), p_parser.parse_view(text)
    assert plain(vp) == plain(vr)
    assert vp.pretty() == vr.pretty()
    assert vp.forward == vr.forward


@pytest.mark.parametrize("text", BAD_QUERIES + BAD_VIEWS)
def test_parse_errors_match(text):
    parse = "parse_view" if text.startswith("CREATE") else "parse_query"
    with pytest.raises(ValueError) as er:
        getattr(r_parser, parse)(text)
    with pytest.raises(ValueError) as ep:
        getattr(p_parser, parse)(text)
    assert type(ep.value).__name__ == type(er.value).__name__
    assert str(ep.value) == str(er.value)


def _fake_view(pkg, text, eff):
    """Stand-in for a materialized view: what the optimizer reads."""
    vdef = pkg.parser.parse_view(text)
    return SimpleNamespace(vdef=vdef, name=vdef.name,
                           stats=SimpleNamespace(opt_eff=lambda: eff))


@pytest.mark.parametrize("qtext", QUERIES)
def test_match_view_and_optimize_match(qtext):
    effs = [float(len(VIEWS) - i) for i in range(len(VIEWS))]
    for pkg_views in (slice(None), slice(6, 8), slice(0, 2)):
        outs = []
        for pkg in (REF, PORT):
            q = pkg.parser.parse_query(qtext)
            views = [_fake_view(pkg, t, e)
                     for t, e in zip(VIEWS[pkg_views], effs[pkg_views])]
            matches = [pkg.matcher.match_view(q.path, v.vdef.match)
                       for v in views]
            rw = pkg.opt.optimize_query(q, views)
            outs.append((plain(matches), plain(rw), rw.pretty()))
        assert outs[0] == outs[1]
