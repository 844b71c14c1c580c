"""AMP op classification lists (reference:
``python/mxnet/contrib/amp/lists/symbol_fp16.py``): which ops run in the
reduced dtype, which stay float32, and which unify their inputs to the
widest dtype.  The same lists as the JAX package's.

The target dtype defaults to bfloat16 (float32's exponent range, so the
fp16 overflow the reference's lists guard against is milder); float16
can be chosen explicitly, with the loss scaler.
"""

# matrix-product ops: the FLOPs live here — run in the target (bf16) dtype.
TARGET_DTYPE_OPS = [
    "FullyConnected",
    "Convolution",
    "Deconvolution",
    "dot",
    "batch_dot",
    "RNN",
    "_contrib_interleaved_matmul_selfatt_qk",
    "_contrib_interleaved_matmul_selfatt_valatt",
    "_contrib_interleaved_matmul_encdec_qk",
    "_contrib_interleaved_matmul_encdec_valatt",
]

# Numerically sensitive ops: always fp32 (reductions, exp/log families,
# losses, normalizations that divide by small variances).
FP32_OPS = [
    "softmax",
    "log_softmax",
    "softmin",
    "SoftmaxActivation",
    "SoftmaxOutput",
    "softmax_cross_entropy",
    "CTCLoss",
    "BatchNorm",
    "LayerNorm",
    "InstanceNorm",
    "GroupNorm",
    "L2Normalization",
    "LRN",
    "norm",
    "exp",
    "log",
    "log2",
    "log10",
    "expm1",
    "log1p",
    "mean",
    "sum",
    "erfinv",
    "reciprocal",
    "rsqrt",
    "rcbrt",
    "smooth_l1",
]

# Multi-input elementwise ops whose inputs must agree: cast to the widest
# input dtype (reference: WIDEST_TYPE_CASTS).
WIDEST_TYPE_CASTS = [
    "broadcast_add",
    "broadcast_sub",
    "broadcast_mul",
    "broadcast_div",
    "elemwise_add",
    "elemwise_sub",
    "elemwise_mul",
    "elemwise_div",
    "add_n",
    "concat",
    "where",
]
