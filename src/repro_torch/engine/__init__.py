from repro_torch.engine.api import (SCHEMES, Executor,  # noqa: F401
                                    get_executor, validate_scheme)
from repro_torch.engine.network import (FixedLatencyNetwork,  # noqa: F401
                                        GeometricDelayNetwork, InstantNetwork,
                                        NetworkModel, get_network)
