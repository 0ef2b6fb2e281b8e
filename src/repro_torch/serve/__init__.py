from repro_torch.serve.engine import (ContinuousEngine,  # noqa: F401
                                     ServeEngine, ServeReport,
                                     make_requests, make_serve_steps)
from repro_torch.serve.kvcache import (BlockAllocator,  # noqa: F401
                                       PagedCache, n_pages)
from repro_torch.serve.scheduler import Request, Scheduler  # noqa: F401
from repro_torch.serve.tp import (TPContext, TPDecodeConfig,  # noqa: F401
                                  make_tp_context)
