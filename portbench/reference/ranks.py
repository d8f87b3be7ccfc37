"""What each rank's collectives in one probe cycle are defined to return, and
how many collective calls each rank is defined to make, for a group of ``n``
ranks on one node, worked out from the stages' definitions (the port's
``probe/ici.py``, ``probe/links.py``, ``probe/agent.py`` and
``parallel/collectives.py``, as the JAX package's ``probe/`` defines them).
Nothing here imports the port or reads what it made; the values are float64.

- the latency chain: rank ``r`` puts in ``r + 1``, and each of its rounds is
  an all-reduce (sum) and a division by ``n``: every round leaves the mean,
  ``(n + 1) / 2``, on every rank;
- the bandwidth all-reduce: every rank puts in ``payload_bytes / 2``
  bfloat16 ones (at least 128), so every element of the sum is ``n``;
- a pair exchange over a link ``(a, b)``: ``a`` puts in 1 and ``b`` 2; an
  even number of swaps brings each value home, and one more swap and an add
  leave ``1 + 2`` on both ends;
- the findings gather: row ``j`` is what rank ``j`` put in;
- the link walk: the ring of the node's ``n`` ranks, with the wraparound edge
  where ``n > 2``, so ``n`` links for ``n > 2``.

The calls, each a call into ``torch.distributed`` (a batched send and
receive counts one):

- the latency chain: one warm-up call and ``CHAIN_ITERS`` timed calls, each
  of ``CHAIN_INNER`` all-reduces;
- the bandwidth all-reduce: one warm-up and ``BANDWIDTH_ITERS`` timed;
- the link walk: one all-reduce where the ranks agree that every link is
  prepared; for each link that touches the rank, one warm-up call and
  ``LINK_ITERS`` timed calls, each of ``LINK_INNER`` exchanges and one more
  to close the round trip; one all-gather of the link records;
- the findings gather: one all-gather; the ranks' identities: one all-gather
  in the group's first cycle;
- the stop vote: one all-reduce.

On the card each timed call of the chain, of the bandwidth all-reduce and
of a link is a CUDA graph, captured in the group's first cycle and launched
after (no call into ``torch.distributed``), behind a barrier graph: one more
all-reduce, or one more exchange with the link's peer. A capture runs its
call once and then captures it (two calls of each), and its members agree
on it in one more all-reduce or exchange. The warm-up calls are launches of
the graphs too. A group of one rank makes the latency chain's all-reduces
alone, over its group of one and timed on the host; every other collective
needs a peer.
"""

from __future__ import annotations

import dataclasses

CHAIN_ITERS, CHAIN_INNER = 10, 10
BANDWIDTH_ITERS = 3  # max(3, CHAIN_ITERS // 3)
LINK_ITERS, LINK_INNER = 5, 8
PAIR_INPUTS = (1.0, 2.0)  # the two ends' values


def chain_fixed_point(n: int) -> float:
    """The latency chain's output on every rank."""
    shares = [float(r + 1) for r in range(n)]
    value = shares
    for _ in range(CHAIN_INNER):
        value = [sum(value) / n] * n
    return value[0]


def bandwidth_elements(payload_bytes: int) -> int:
    """How many bfloat16 elements a rank puts in."""
    return max(128, payload_bytes // 2)


def bandwidth_sum(n: int) -> float:
    """Every element of the bandwidth all-reduce's output: the sum of the
    ranks' ones."""
    return float(sum(1.0 for _ in range(n)))


def pair_round_trip() -> float:
    """A pair exchange's output on both ends of the link."""
    a, b = PAIR_INPUTS
    for _ in range(LINK_INNER):  # each swap sends what the last one received
        a, b = b, a
    return a + b  # one more swap and an add


def ring_links(n: int) -> list:
    """``(name, rank_a, rank_b)`` of every link the walk covers on one node
    of ``n`` ranks, named as the stage names them."""
    links = [(f"host0/chip{c}-chip{c + 1}", c, c + 1) for c in range(n - 1)]
    if n > 2:
        links.append((f"host0/chip{n - 1}-chip0", n - 1, 0))
    return links


def gathered_rows_off(inputs: list, rows: list) -> int:
    """How many of one rank's gathered ``rows`` differ from what their rank
    put in (``inputs[j]`` is rank ``j``'s); a row missing or one too many
    counts too."""
    off = sum(1 for want, got in zip(inputs, rows) if want != got)
    return off + abs(len(inputs) - len(rows))


@dataclasses.dataclass(frozen=True)
class CollectivePlan:
    """The collective calls of one cycle on each rank of ``n``."""

    n: int
    links_enabled: bool = True
    on_card: bool = False  # timed calls as kept graphs, each behind a barrier graph

    def calls(self, rank: int, first: bool) -> dict:
        """``{"all_reduce", "all_gather", "exchange": count}`` of ``rank``'s
        cycle; ``first``: the group's first cycle."""
        chain = (1 + CHAIN_ITERS) * CHAIN_INNER
        if self.n == 1:
            return {"all_reduce": chain, "all_gather": 0, "exchange": 0}
        links = [link for link in ring_links(self.n) if rank in link[1:]] if self.links_enabled else []
        all_reduce = 1 + (1 if self.links_enabled else 0)  # the vote; the walk's agreement
        all_gather = 1 + (1 if first else 0) + (1 if self.links_enabled else 0)  # findings, identities, records
        if not self.on_card:
            all_reduce += chain + 1 + BANDWIDTH_ITERS  # the chain; the payload's warm-up and timed calls
            return {"all_reduce": all_reduce, "all_gather": all_gather,
                    "exchange": len(links) * (1 + LINK_ITERS) * (LINK_INNER + 1)}
        if first:  # each graph: its call twice, its barrier's twice, one agreement
            all_reduce += (2 * CHAIN_INNER + 2 + 1) + (2 + 2 + 1)  # the chain; the payload
        exchange = len(links) * (2 * (LINK_INNER + 1) + 2 + 1) if first else 0
        return {"all_reduce": all_reduce, "all_gather": all_gather, "exchange": exchange}

    def total(self, rank: int, first: bool) -> int:
        return sum(self.calls(rank, first).values())

    def bandwidth_bus_bytes(self, payload_bytes: int) -> float:
        """The bus bytes of one timed bandwidth all-reduce: 2 (n - 1) / n of
        the payload, the ring algorithm's traffic on each link."""
        return 2.0 * (self.n - 1) / self.n * 2 * bandwidth_elements(payload_bytes)
