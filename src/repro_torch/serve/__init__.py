from .engine import (Engine, ServeEngine, generate, make_decode_step,
                     make_paged_decode_step, make_paged_prefill,
                     make_prefill)
from repro_torch.models import init_cache, supports_ragged_mask
from .paged_cache import PageAllocator, PagedKVCache, PrefixIndex, pages_for
from .scheduler import (Scheduler, Request, QUEUED, PREFILLING, DECODING,
                        FINISHED, EVICTED)
from .encoded import (prepare_encoded_serving, capture_activation_stats,
                      family_row_weights, search_family_encodings,
                      fold_linear_params, exact_encodings, arch_families,
                      prepare_drafter)
from .spec import (greedy_accept, rejection_sample, make_spec_draft,
                   make_spec_verify)
