from .uniform import qmax, calibrate_scale, quantize_codes
from .kvcache import kv_mode_of, kv_pool_layout
