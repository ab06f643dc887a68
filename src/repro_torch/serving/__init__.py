"""Serving (the port of `repro.serving`): the paged KV cache over a
CacheHash page table and the continuous-batching engine, on one device."""
from repro_torch.serving.paged_kv import (  # noqa: F401
    PagedKV, init_paged, lookup_pages, alloc_pages, free_pages, page_key,
)
from repro_torch.serving.engine import (  # noqa: F401
    Admitted, OverloadPolicy, Request, ServingEngine, Shed,
)
