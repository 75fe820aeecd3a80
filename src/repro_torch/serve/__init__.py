"""Online coreset serving (port of :mod:`repro.serve`).

  * :mod:`repro_torch.serve.tree` — :class:`CoresetTree`: merge-and-reduce
    maintenance of one task's coreset over a row stream (pipelined-engine
    leaves on the card, weighted-union DIS merges, exact composed ledger).
  * :mod:`repro_torch.serve.service` — :class:`CoresetService`: many
    tenants, one shared plan cache, cross-tenant batching of one-shot
    builds on the card.
  * :mod:`repro_torch.serve.resilience` — admission control and failure
    isolation: :class:`TokenBucket`, :class:`CircuitBreaker`, and the
    :class:`ShedReceipt` every refused request returns.

(The language model's ``ServeEngine`` lives in
:mod:`repro_torch.models.lm_serve`; it is re-exported here — deprecated —
as the reference re-exports it.)
"""

from repro_torch.models.lm_serve import ServeEngine, make_serve_step   # deprecated
from repro_torch.serve.resilience import CircuitBreaker, ShedReceipt, TokenBucket
from repro_torch.serve.service import (
    CoresetService,
    EvictReceipt,
    InsertReceipt,
    QueryReceipt,
    TenantState,
)
from repro_torch.serve.tree import CoresetTree, InsertStats, TreeNode, merge_reduce

__all__ = [
    "CoresetTree",
    "TreeNode",
    "InsertStats",
    "merge_reduce",
    "CoresetService",
    "TenantState",
    "InsertReceipt",
    "QueryReceipt",
    "EvictReceipt",
    "ShedReceipt",
    "TokenBucket",
    "CircuitBreaker",
    # deprecated LM re-exports
    "ServeEngine",
    "make_serve_step",
]
