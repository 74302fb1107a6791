from .uniform import (qmax, calibrate_scale, quantize_codes, dequantize,
                      fake_quant, uniform_levels)
from .nonuniform import kmeans_levels, nonuniform_codes, map_levels_to_int8
from .kvcache import (KV_DTYPES, kv_mode_of, kv_pool_layout, quantize_kv,
                      dequantize_kv, pack_int4, unpack_int4)
