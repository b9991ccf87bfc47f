from repro_torch.comm.api import (CommLog, CommRecord, Transport,  # noqa: F401
                                  get_transport, ring_wire_bytes,
                                  tree_f32_bytes)
from repro_torch.comm.hier import HierarchicalTransport  # noqa: F401
from repro_torch.comm.quant import (QUANT_WIDTH,  # noqa: F401
                                    QuantizedTransport, quantize_leaf)
from repro_torch.comm.ring import (RingTransport,  # noqa: F401
                                   ring_all_reduce, ring_all_reduce_plain)
from repro_torch.comm.sparse import (SparseTransport,  # noqa: F401
                                     sparse_allsum, topk_count)
from repro_torch.comm.xla import XlaTransport  # noqa: F401
