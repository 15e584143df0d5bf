"""mv4pg: the paper's own workload configuration (views + queries + updates).

Defines the SNB-like and FinBench-like workloads mirroring the paper's
evaluation: 3 views per dataset, 7 read + 3 write statements (CE/DE/DV).
Benchmarks consume these; see benchmarks/bench_workload.py."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List


@dataclass(frozen=True)
class WorkloadConfig:
    name: str
    views: List[str]
    reads: List[str]
    # write statements are realized by the driver: create-edge CE,
    # delete-edge DE, delete-node DV (paper Tables IV/VI rows Q8-Q10)


SNB_WORKLOAD = WorkloadConfig(
    name="snb",
    views=[
        """CREATE VIEW ROOT_POST AS (
           CONSTRUCT (c)-[r:ROOT_POST]->(p)
           MATCH (c:Comment)-[:replyOf*..]->(p:Post))""",
        """CREATE VIEW COMMENT_TAG AS (
           CONSTRUCT (c)-[r:COMMENT_TAG]->(t)
           MATCH (c:Comment)-[:replyOf*1..2]->(p:Post)-[:hasTag]->(t:Tag))""",
        """CREATE VIEW KNOWS2 AS (
           CONSTRUCT (a)-[r:KNOWS2]->(b)
           MATCH (a:Person)-[:knows]->(m:Person)-[:knows]->(b:Person))""",
    ],
    reads=[
        "MATCH (c:Comment)-[:replyOf*..]->(p:Post) RETURN c, p",
        "MATCH (c:Comment)-[:replyOf*..]->(p:Post)-[:hasTag]->(t:Tag) RETURN c, t",
        "MATCH (a:Person)-[:knows]->(m:Person)-[:knows]->(b:Person) RETURN a, b",
        "MATCH (a:Person)-[:knows]->(m:Person)-[:knows]->(b:Person)-[:livesIn]->(p:Place) RETURN a, p",
        "MATCH (c:Comment)-[:replyOf*1..2]->(p:Post)-[:hasTag]->(t:Tag) RETURN c, t",
        "MATCH (p:Post)<-[:replyOf*..]-(c:Comment) RETURN p, c",
        "MATCH (a:Person)-[:knows]->(m:Person)-[:knows]->(b:Person)-[:created]->(c:Comment) RETURN a, c",
    ],
)

FINBENCH_WORKLOAD = WorkloadConfig(
    name="finbench",
    views=[
        """CREATE VIEW TRANSFER3 AS (
           CONSTRUCT (a)-[r:TRANSFER3]->(b)
           MATCH (a:Account)-[:transfer*1..3]->(b:Account))""",
        """CREATE VIEW PERSON_LOAN AS (
           CONSTRUCT (p)-[r:PERSON_LOAN]->(l)
           MATCH (p:Person)-[:apply]->(l:Loan))""",
        """CREATE VIEW ACCOUNT_LOAN AS (
           CONSTRUCT (a)-[r:ACCOUNT_LOAN]->(l)
           MATCH (a:Account)<-[:deposit]-(l:Loan))""",
    ],
    reads=[
        "MATCH (a:Account)-[:transfer*1..3]->(b:Account) RETURN a, b",
        "MATCH (p:Person)-[:own]->(a:Account)-[:transfer*1..3]->(b:Account) RETURN p, b",
        "MATCH (a:Account)-[:transfer*1..3]->(b:Account)<-[:deposit]-(l:Loan) RETURN a, l",
        "MATCH (p:Person)-[:apply]->(l:Loan) RETURN p, l",
        "MATCH (p:Person)-[:apply]->(l:Loan)-[:deposit]->(a:Account) RETURN p, a",
        "MATCH (b:Account)<-[:transfer*1..3]-(a:Account) RETURN b, a",
        "MATCH (c:Company)-[:own]->(a:Account)-[:transfer*1..3]->(b:Account) RETURN c, b",
    ],
)

WORKLOADS: Dict[str, WorkloadConfig] = {
    "snb": SNB_WORKLOAD,
    "finbench": FINBENCH_WORKLOAD,
}
