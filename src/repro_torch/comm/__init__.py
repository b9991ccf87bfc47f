from repro_torch.comm.api import (CommLog, CommRecord, Transport,  # noqa: F401
                                  get_transport, ring_wire_bytes,
                                  tree_f32_bytes)
