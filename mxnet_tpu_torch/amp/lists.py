"""AMP op lists (counterpart of ``mxnet_tpu/amp/lists.py``, itself after the
reference's ``python/mxnet/contrib/amp/lists/symbol_fp16.py``).

The port's own copy: every operator of the port's registry
(``ops.registry.list_ops()``) sits in exactly one of the four lists, with
the reference's classification of the same name
(``tests/test_torch_amp.py`` holds both facts):

- LOW_PRECISION_FUNCS: matmul and conv class ops, cast down to the AMP
  dtype (the fused conv + batch-norm ops have the policy's own rule: their
  trailing gamma and beta stay fp32, ``amp._policy``);
- FP32_FUNCS: numerically sensitive ops pinned to fp32: normalization,
  softmax and losses, the exp / log family, statistics-feeding reductions
  and the optimizer updates;
- WIDEST_TYPE_CASTS: multi-input elementwise ops that follow their widest
  input;
- FP16_FP32_FUNCS: dtype-neutral ops, left as they come.

A new op lands in one of them or fails the test.
"""

LOW_PRECISION_FUNCS = [
    "FullyConnected", "Convolution", "Deconvolution", "dot", "batch_dot",
    "_fused_conv1x1_bn", "_fused_convkxk_bn", "_fused_conv1x1_bn_act",
]

FP32_FUNCS = [
    "BatchNorm", "LayerNorm", "GroupNorm", "InstanceNorm", "LRN",
    "L2Normalization", "softmax", "log_softmax", "softmin",
    "softmax_cross_entropy", "SoftmaxOutput", "CTCLoss", "MakeLoss",
    "smooth_l1", "exp", "log", "log2", "log10", "log1p", "expm1", "square",
    "sqrt", "rsqrt", "cbrt", "rcbrt", "power_scalar", "reciprocal",
    "softrelu", "log_sigmoid", "mish", "erf", "erfinv", "gamma", "gammaln",
    "hypot_scalar", "norm", "mean", "sum", "prod", "nansum", "nanprod",
    "cumsum", "cumprod", "moments", "multi_sum_sq", "arccos", "arcsin",
    "arctan", "arccosh", "arcsinh", "arctanh", "degrees", "radians",
    "sgd_update", "sgd_mom_update", "nag_mom_update", "adam_update",
    "adamw_update", "adagrad_update", "adadelta_update", "ftrl_update",
    "rmsprop_update", "rmspropalex_update", "signsgd_update",
    "signum_update", "lamb_update_phase1", "lamb_update_phase2",
    "multi_sgd_update", "multi_sgd_mom_update", "multi_lamb_update",
    "multi_lans_update",
]

WIDEST_TYPE_CASTS = [
    "broadcast_add", "broadcast_sub", "broadcast_mul", "broadcast_div",
    "broadcast_mod", "broadcast_power", "broadcast_maximum",
    "broadcast_minimum", "broadcast_hypot", "add_n", "concat", "stack",
    "where", "amp_multicast",
]

FP16_FP32_FUNCS = [
    "Activation", "LeakyReLU", "relu", "sigmoid", "tanh", "softsign",
    "hard_sigmoid", "abs", "sign", "negative", "ceil", "floor", "rint",
    "fix", "trunc", "clip", "sin", "cos", "tan", "sinh", "cosh",
    "maximum_scalar", "minimum_scalar", "add_scalar", "sub_scalar",
    "mul_scalar", "div_scalar", "mod_scalar", "equal_scalar",
    "not_equal_scalar", "greater_scalar", "greater_equal_scalar",
    "lesser_scalar", "lesser_equal_scalar", "broadcast_equal",
    "broadcast_not_equal", "broadcast_greater", "broadcast_greater_equal",
    "broadcast_lesser", "broadcast_lesser_equal", "broadcast_logical_and",
    "broadcast_logical_or", "broadcast_logical_xor", "logical_not",
    "logical_and_scalar", "logical_or_scalar", "logical_xor_scalar",
    "isnan", "isinf", "isfinite", "all_finite", "multi_all_finite",
    "reshape", "npx_reshape", "flatten", "transpose", "expand_dims",
    "squeeze", "swapaxes", "slice", "slice_axis", "slice_like", "split",
    "take", "embedding", "one_hot", "pick", "gather_nd", "scatter_nd",
    "broadcast_axis", "broadcast_to", "repeat", "tile", "reverse", "roll",
    "pad", "depth_to_space", "space_to_depth", "diag", "sequence_mask",
    "sequence_last", "sequence_reverse", "shape_array", "size_array",
    "cast", "_copy", "_index", "BlockGrad", "argmax", "argmin",
    "argmax_channel", "argsort", "sort", "topk", "max", "min", "unique",
    "Pooling", "UpSampling", "Dropout", "zeros", "ones", "full", "eye",
    "arange", "linspace", "zeros_like", "ones_like", "normal", "uniform",
    "randint", "randn", "bernoulli", "exponential", "poisson",
    "negative_binomial", "random_gamma", "multinomial", "shuffle",
    "ftml_update", "group_adagrad_update", "multi_lars", "mp_sgd_update",
    "mp_sgd_mom_update", "mp_nag_mom_update", "mp_lamb_update_phase1",
    "mp_lamb_update_phase2", "multi_mp_sgd_update",
    "multi_mp_sgd_mom_update", "preloaded_multi_sgd_update",
    "preloaded_multi_sgd_mom_update", "preloaded_multi_mp_sgd_update",
    "preloaded_multi_mp_sgd_mom_update", "amp_cast", "mp_adamw_update",
    "multi_adamw_update", "multi_mp_adamw_update", "multi_mp_lamb_update",
    "multi_mp_lans_update",
]
