"""Online quantization serving, counterpart of ``repro/serve``.

A ``CodebookStore`` holds versioned, hot-swappable codebooks; a
``QuantizeService`` micro-batches nearest-prototype queries onto
``ShardedLookup`` (the assign kernel); ``loadgen`` drives it with the
engine's ``NetworkModel`` arrival processes.

    store   = CodebookStore(w0)
    service = QuantizeService(store, ShardedLookup()).start()
    resp    = service.quantize(z)          # rides a coalesced batch

Over a process group rank 0 runs the service on a
``ShardedLookup(group=)`` and the other ranks run ``follow(lookup)``.
"""

from repro_torch.serve.codebook_store import (CodebookSnapshot,  # noqa: F401
                                              CodebookStore)
from repro_torch.serve.loadgen import (LoadReport, arrival_gaps_s,  # noqa: F401
                                       run_load)
from repro_torch.serve.lookup import ShardedLookup  # noqa: F401
from repro_torch.serve.service import (QuantizeRequest,  # noqa: F401
                                       QuantizeResponse, QuantizeService,
                                       ServiceStats, follow)
