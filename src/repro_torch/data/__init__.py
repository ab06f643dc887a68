from repro_torch.data.pipeline import (  # noqa: F401
    DataPipeline, make_memmap_corpus, synthetic_batch, to_device,
)
