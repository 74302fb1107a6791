"""The port's analysis (port of ``repro/analysis``).  Six parts, one
runner (``python -m repro_torch.analysis``):

  * ``lint``        AST rules over ``src/repro_torch`` and its CUDA
                    sources (host-sync-in-hot-path, jit-in-loop,
                    f32-accum, metric-docs-sync; ``rules/``);
  * ``kernelcheck`` the kernels' launch plans over every registry
                    geometry, the constants the Python mirrors of the
                    ``.cu`` files and the ctypes launcher ABI;
  * ``shardcheck``  every TP arch's full tree on the meta device against
                    the sharding rules (params, pools, fold roles, train
                    dims);
  * ``compiled``    the captured steps: capture counts, donation, capture
                    purity and the TP collective table;
  * ``selftest``    one seeded defect per check;
  * ``ledger``      the runtime sibling: the allocator's shadow page
                    ledger (``Engine(sanitize=True)``).

Only the ledger is exported here: the checkers import large parts of the
port, and ``serve/paged_cache.py`` imports this package.
"""
from .ledger import LedgerError, PageLedger, attach_ledger, sanitize_enabled
