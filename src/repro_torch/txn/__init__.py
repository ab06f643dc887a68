"""repro_torch.txn — transactions over big atomics (PyTorch).

Three layers, all dispatching through the strategy registry:

  mcas         batched k-word MCAS: groups of (slot, expected, desired)
               lanes commit all-or-nothing via LL-all / VALIDATE-all /
               one-round-SC on the unified engine, conflicts arbitrated by
               txn-group id (no descriptors), losers backing off Dice-style.
  versionlist  per-slot bounded version chains with the newest version
               inline in a big-atomic head cell: timestamped
               `snapshot_read` of arbitrary slot sets (`core.multiversion`
               rides on it).
  map          optimistic transactional map over CacheHash: read-set /
               write-set, validate + commit, serializable, retried in a
               host loop.

The mesh-sharded MCAS is `core.distributed.mcas`; the sharded map,
`map.transact_dist`, is not ported yet and raises (ROADMAP Queue 1 item
8b).
"""

from repro_torch.txn import map as map  # noqa: F401  (txn.map module alias)
from repro_torch.txn import mcas as mcas  # noqa: F401
from repro_torch.txn import versionlist as versionlist  # noqa: F401
from repro_torch.txn.map import (  # noqa: F401
    MapResult, MapTxns, make_map_txns, transact, transact_dist,
    transact_reference,
)
from repro_torch.txn.mcas import (  # noqa: F401
    McasResult, TxnBatch, make_txns, mcas_reference,
)
from repro_torch.txn.mcas import mcas as run_mcas  # noqa: F401
from repro_torch.txn.versionlist import (  # noqa: F401
    VersionState, init as init_versions, latest, publish, snapshot_read,
)
