"""Online coreset serving (port of :mod:`repro.serve`).

  * :mod:`repro_torch.serve.tree` — :class:`CoresetTree`: merge-and-reduce
    maintenance of one task's coreset over a row stream (pipelined-engine
    leaves on the card, weighted-union DIS merges, exact composed ledger).

The multi-tenant service and its admission control come with the next
slice; the language model's ``ServeEngine`` comes with the LM side.
"""

from repro_torch.serve.tree import CoresetTree, InsertStats, TreeNode, merge_reduce

__all__ = [
    "CoresetTree",
    "TreeNode",
    "InsertStats",
    "merge_reduce",
]
