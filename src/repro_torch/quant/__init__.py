from .uniform import qmax, calibrate_scale, quantize_codes
from .kvcache import (KV_DTYPES, kv_mode_of, kv_pool_layout, quantize_kv,
                      dequantize_kv, pack_int4, unpack_int4)
