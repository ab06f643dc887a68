"""Targets of the executor: the shared big-atomic structure streams contend
on.

`LocalTarget` wraps one table on one device: rounds ride
`engine.apply_round` with donation, so the table is updated in place and
the in-flight window holds no copies of it.  Snapshots are
`{"logical", "versions"}` dicts of word tensors on the table's device (the
plane the integrity scrub checkpoints and repairs); `convert.snapshot`
brings a reference snapshot (numpy uint32) across.  The multi-stream
`Executor` and the sharded target come with the runtime slice.
"""

from __future__ import annotations

from repro_torch.core import engine
from repro_torch.core.layout import as_words, resolve_device


class LocalTarget:
    """Single-device table; `issue` updates it in place."""

    kind = "local"

    def __init__(self, spec, initial=None, *, device="cuda"):
        self.spec = spec
        self.device = resolve_device(device)
        self.state = engine.init(spec, initial, device=self.device)

    @property
    def width(self) -> int:
        return self.spec.n          # no lane cap beyond table size

    @property
    def n_shards(self) -> int:
        return 1

    def issue(self, ops, ctx, *, donate=True):
        h = engine.apply_round(self.spec, self.state, ops, ctx,
                               donate=donate)
        self.state = h.state
        return h

    def snapshot(self) -> dict:
        """A copy of the logical plane and the versions (word tensors)."""
        return {"logical": engine.logical(self.spec, self.state).clone(),
                "versions": self.state.version.clone()}

    def load(self, snap: dict) -> None:
        """Rebuild the layout from a snapshot (numpy uint32 or word
        tensors); the snapshot's buffers are copied, never aliased."""
        logical = as_words(snap["logical"], self.device).clone()
        versions = as_words(snap["versions"], self.device).clone()
        self.state = engine.init(self.spec, logical, device=self.device
                                 )._replace(version=versions)

    def shrink(self, n_surviving: int):
        raise RuntimeError("shard loss against a LocalTarget is fatal: "
                           "nothing to reshard onto")
