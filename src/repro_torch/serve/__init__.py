from .engine import Engine
from .paged_cache import PageAllocator, PagedKVCache, pages_for
from .scheduler import (Scheduler, Request, QUEUED, PREFILLING, DECODING,
                        FINISHED, EVICTED)
from .encoded import (prepare_encoded_serving, capture_activation_stats,
                      fold_linear_params, exact_encodings)
