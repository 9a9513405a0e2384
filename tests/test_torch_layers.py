"""The port's layer catalog against the JAX package's, layer by layer.

Every layer type `mscnn_torch/models/netbuilder.py` executes, as a
one-layer net through both builders on the same seeded numpy inputs
(`_torch_net_check.run_both`): the forward tops and the gradients of a
fixed random weighting of them (with the loss) with respect to every
float input and param, float32, rtol 1e-5 / atol 1e-6. The params are the
port's init, checked to have the JAX init's leaves and shapes, moved so
that every bias, slope and running statistic is nonzero. The op-level
checks (the reference-executed fixtures, stochastic pooling, the
fillers) are in tests/test_torch_layer_ops.py.
"""

import numpy as np
import pytest

from _torch_net_check import check_both, run_both
from mscnn_torch.models import netbuilder as TNB
from mscnn_tpu.models import netbuilder as JNB
from _torch_threads import few_threads  # noqa: F401  (autouse: one thread)

RTOL, ATOL = 1e-5, 1e-6

# --------------------------------------------------------------------------
# One-layer nets through both builders
# --------------------------------------------------------------------------

R = np.random.RandomState


def _x(shape, seed=0, lo=-1.0, hi=1.0):
    return R(seed).uniform(lo, hi, shape).astype(np.float32)


def _ints(shape, hi, seed=1):
    return R(seed).randint(0, hi, shape).astype(np.int32)


X = _x((2, 5, 6, 4))
FILL = 'weight_filler { type: "gaussian" std: 0.3 } ' \
       'bias_filler { type: "gaussian" std: 0.3 }'


def _tie(a, seed):
    """b equal to a on a third of the entries (Eltwise MAX's tie rule)."""
    b = _x(a.shape, seed)
    return np.where(R(seed + 7).rand(*a.shape) < 0.34, a, b).astype(np.float32)


def _probs(n, k, seed):
    p = R(seed).rand(n, k).astype(np.float32) + 0.1
    return (p / p.sum(1, keepdims=True)).astype(np.float32)


# id -> (layer text, {bottom: array}, tops, train)
CASES = {
    "ReLU": ('type: "ReLU" relu_param { negative_slope: 0.1 }', {"x": X}),
    "PReLU": ('type: "PReLU"', {"x": X}),
    "PReLU_shared": ('type: "PReLU" prelu_param { channel_shared: true }',
                     {"x": X}),
    "ELU": ('type: "ELU" elu_param { alpha: 0.5 }', {"x": X}),
    "Sigmoid": ('type: "Sigmoid"', {"x": X}),
    "TanH": ('type: "TanH"', {"x": X}),
    "BNLL": ('type: "BNLL"', {"x": X * 8}),
    "AbsVal": ('type: "AbsVal"', {"x": X}),
    "Power": ('type: "Power" power_param { power: 1.5 scale: 0.5 shift: 1.0 }',
              {"x": X}),
    "Exp": ('type: "Exp"', {"x": X}),
    "Log": ('type: "Log"', {"x": X + 1.5}),
    "Threshold": ('type: "Threshold" threshold_param { threshold: 0.1 }',
                  {"x": X}),
    "LRN": ('type: "LRN" lrn_param { local_size: 3 alpha: 0.5 beta: 0.75 '
            'k: 2.0 }', {"x": X}),
    "LRN_within": ('type: "LRN" lrn_param { local_size: 3 alpha: 0.5 '
                   'beta: 0.75 norm_region: WITHIN_CHANNEL }', {"x": X}),
    "BatchNorm": ('type: "BatchNorm"', {"x": X}, None, True),
    "BatchNorm_global": ('type: "BatchNorm" batch_norm_param { '
                         'use_global_stats: true eps: 0.001 }', {"x": X}),
    "MVN": ('type: "MVN"', {"x": X}),
    "MVN_across_mean": ('type: "MVN" mvn_param { across_channels: true '
                        'normalize_variance: false }', {"x": X}),
    "Scale": ('type: "Scale" scale_param { bias_term: true }', {"x": X}),
    "Bias": ('type: "Bias" bias_param { filler { type: "gaussian" } }',
             {"x": X}),
    "Bias_bottom": ('type: "Bias"', {"x": X, "b": _x((4,), 3)}),
    "Concat": ('type: "Concat"', {"x": X, "y": _x((2, 5, 6, 3), 2)}),
    "Concat_axis2": ('type: "Concat" concat_param { axis: 2 }',
                     {"x": X, "y": _x((2, 3, 6, 4), 2)}),
    "Slice": ('type: "Slice" slice_param { axis: 1 slice_point: 1 '
              'slice_point: 3 }', {"x": X}, ("t0", "t1", "t2")),
    "Slice_even": ('type: "Slice" slice_param { axis: 2 }', {"x": X},
                   ("t0", "t1")),
    "Split": ('type: "Split"', {"x": X}, ("t0", "t1")),
    "Flatten": ('type: "Flatten"', {"x": X}),
    "Reshape": ('type: "Reshape" reshape_param { shape { dim: 0 dim: -1 '
                'dim: 3 dim: 2 } }', {"x": X}),
    "Reshape_2d": ('type: "Reshape" reshape_param { shape { dim: 0 '
                   'dim: -1 } }', {"x": X}),
    "Eltwise_sum": ('type: "Eltwise" eltwise_param { operation: SUM '
                    'coeff: 0.5 coeff: -2.0 }', {"x": X, "y": _x(X.shape, 4)}),
    "Eltwise_prod": ('type: "Eltwise" eltwise_param { operation: PROD }',
                     {"x": X, "y": _x(X.shape, 4), "z": _x(X.shape, 5)}),
    "Eltwise_max": ('type: "Eltwise" eltwise_param { operation: MAX }',
                    {"x": X, "y": _tie(X, 4)}),
    "Crop": ('type: "Crop" crop_param { axis: 2 offset: 1 offset: 2 }',
             {"x": _x((2, 7, 8, 3), 5), "r": _x((2, 4, 5, 3), 6)}),
    "Tile": ('type: "Tile" tile_param { axis: 1 tiles: 2 }', {"x": X}),
    "ArgMax": ('type: "ArgMax" argmax_param { top_k: 2 }', {"x": _x((3, 7), 7)}),
    "ArgMax_maxval": ('type: "ArgMax" argmax_param { top_k: 3 '
                      'out_max_val: true }', {"x": _x((3, 7), 7)}),
    "BatchReindex": ('type: "BatchReindex"',
                     {"x": _x((4, 3), 8), "i": _ints((6,), 4)}),
    "Embed": ('type: "Embed" embed_param { input_dim: 7 num_output: 3 ' + FILL
              + ' }', {"i": _ints((5,), 7)}),
    "Reduction_sum": ('type: "Reduction" reduction_param { axis: 1 }',
                      {"x": _x((3, 5), 9)}),
    "Reduction_asum": ('type: "Reduction" reduction_param { operation: ASUM '
                       'axis: 1 coeff: 0.5 }', {"x": X}),
    "Reduction_sumsq": ('type: "Reduction" reduction_param { operation: '
                        'SUMSQ }', {"x": _x((3, 5), 9)}),
    "Reduction_mean": ('type: "Reduction" reduction_param { operation: MEAN '
                       'axis: 1 }', {"x": _x((3, 5), 9)}),
    "Silence": ('type: "Silence"', {"x": X}, ()),
    "Filter": ('type: "Filter"', {"x": _x((5, 3), 10), "y": _x((5,), 11),
                                  "s": np.array([1, 0, 1, 0, 1], np.float32)},
               ("t0", "t1")),
    "SPP": ('type: "SPP" spp_param { pyramid_height: 2 }',
            {"x": _x((2, 7, 5, 3), 12)}),
    "SPP_ave": ('type: "SPP" spp_param { pyramid_height: 3 pool: AVE }',
                {"x": _x((2, 9, 8, 3), 12)}),
    "Im2col": ('type: "Im2col" convolution_param { kernel_size: 3 stride: 2 '
               'pad: 1 }', {"x": X}),
    "Im2col_dilated": ('type: "Im2col" convolution_param { kernel_size: 2 '
                       'dilation: 2 }', {"x": X}),
    "Convolution": ('type: "Convolution" convolution_param { num_output: 3 '
                    'kernel_size: 3 stride: 2 pad: 1 ' + FILL + ' }',
                    {"x": X}),
    "Convolution_rect": ('type: "Convolution" convolution_param { '
                         'num_output: 2 kernel_h: 1 kernel_w: 3 ' + FILL
                         + ' }', {"x": X}),
    "Deconvolution": ('type: "Deconvolution" convolution_param { '
                      'num_output: 3 kernel_size: 4 stride: 2 pad: 1 ' + FILL
                      + ' }', {"x": X}),
    "Deconvolution_group": ('type: "Deconvolution" convolution_param { '
                            'num_output: 6 kernel_size: 3 stride: 2 group: 2 '
                            + FILL + ' }', {"x": X}),
    "InnerProduct": ('type: "InnerProduct" inner_product_param { '
                     'num_output: 5 ' + FILL + ' }', {"x": X}),
    "Pooling_max": ('type: "Pooling" pooling_param { pool: MAX kernel_size: 3 '
                    'stride: 2 pad: 1 }', {"x": X}),
    "Pooling_ave_rect": ('type: "Pooling" pooling_param { pool: AVE '
                         'kernel_h: 2 kernel_w: 3 stride_h: 1 stride_w: 2 '
                         'pad_w: 1 }', {"x": X}),
    "Pooling_global_max": ('type: "Pooling" pooling_param { pool: MAX '
                           'global_pooling: true }', {"x": X}),
    "Pooling_global_ave": ('type: "Pooling" pooling_param { pool: AVE '
                           'global_pooling: true }', {"x": X}),
    "Pooling_stochastic_test": ('type: "Pooling" pooling_param { pool: '
                                'STOCHASTIC kernel_size: 3 stride: 2 }',
                                {"x": X + 1.0}),
    "Pooling_stochastic_train": ('type: "Pooling" pooling_param { pool: '
                                 'STOCHASTIC kernel_size: 3 stride: 2 }',
                                 {"x": X + 1.0}, None, True),
    "Pooling_stochastic_global": ('type: "Pooling" pooling_param { pool: '
                                  'STOCHASTIC global_pooling: true }',
                                  {"x": _x((2, 5, 5, 3), 13, 0.0, 1.0)},
                                  None, True),
    "Dropout": ('type: "Dropout" dropout_param { dropout_ratio: 0.3 }',
                {"x": X}, None, True),
    "Dropout_test": ('type: "Dropout"', {"x": X}),
    "Softmax": ('type: "Softmax"', {"x": _x((3, 5), 14)}),
    "SoftmaxWithLoss": ('type: "SoftmaxWithLoss" loss_weight: 0.7',
                        {"x": _x((4, 5), 15), "l": _ints((4,), 5)}),
    "Accuracy": ('type: "Accuracy"', {"x": _x((6, 5), 16),
                                      "l": _ints((6,), 5)}),
    "EuclideanLoss": ('type: "EuclideanLoss"', {"x": _x((4, 3), 17),
                                                "y": _x((4, 3), 18)}),
    "HingeLoss": ('type: "HingeLoss"', {"x": _x((4, 5), 19),
                                        "l": _ints((4,), 5)}),
    "HingeLoss_L2": ('type: "HingeLoss" hinge_loss_param { norm: L2 }',
                     {"x": _x((4, 5), 19), "l": _ints((4,), 5)}),
    "InfogainLoss": ('type: "InfogainLoss"',
                     {"p": _probs(4, 5, 20), "l": _ints((4,), 5),
                      "h": _x((5, 5), 21, 0.0, 1.0)}),
    "SigmoidCrossEntropyLoss": ('type: "SigmoidCrossEntropyLoss"',
                                {"x": _x((4, 3), 22) * 3,
                                 "y": _x((4, 3), 23, 0.0, 1.0)}),
    "MultinomialLogisticLoss": ('type: "MultinomialLogisticLoss"',
                                {"p": _probs(4, 5, 24), "l": _ints((4,), 5)}),
    "ContrastiveLoss": ('type: "ContrastiveLoss" contrastive_loss_param { '
                        'margin: 1.5 }', {"a": _x((6, 4), 25),
                                          "b": _x((6, 4), 26),
                                          "y": np.array([1, 0, 1, 0, 0, 1],
                                                        np.float32)}),
    "ContrastiveLoss_legacy": ('type: "ContrastiveLoss" '
                               'contrastive_loss_param { legacy_version: true }',
                               {"a": _x((6, 4), 25), "b": _x((6, 4), 26),
                                "y": np.array([1, 0, 1, 0, 0, 1], np.float32)}),
    "LSTM": ('type: "LSTM" recurrent_param { num_output: 3 ' + FILL + ' }',
             {"x": _x((4, 2, 5), 27)}),
    "LSTM_cont": ('type: "LSTM" recurrent_param { num_output: 3 ' + FILL
                  + ' }', {"x": _x((4, 2, 2, 3), 27),
                           "c": np.array([[0, 0], [1, 1], [0, 1], [1, 0]],
                                         np.float32)}),
    "RNN_cont": ('type: "RNN" recurrent_param { num_output: 3 ' + FILL + ' }',
                 {"x": _x((4, 2, 5), 28),
                  "c": np.array([[0, 0], [1, 1], [1, 0], [1, 1]],
                                np.float32)}),
    "Parameter": ('type: "Parameter" parameter_param { shape { dim: 2 '
                  'dim: 3 } }', {}),
}


def _case(cid):
    body, inputs, *rest = CASES[cid]
    tops = rest[0] if rest and rest[0] is not None else ("t",)
    train = bool(rest[1]) if len(rest) > 1 else False
    return body, inputs, tops, train


def _proto(body, inputs, tops):
    bots = "".join(f' bottom: "{b}"' for b in inputs)
    tps = "".join(f' top: "{t}"' for t in tops)
    return f'layer {{ name: "l"{bots}{tps} {body} }}\n'


@pytest.mark.parametrize("cid", sorted(CASES))
def test_layer_matches_jax(cid):
    body, inputs, tops, train = _case(cid)
    check_both(run_both(_proto(body, inputs, tops), inputs, train, tops))


def test_every_builder_type_has_a_case():
    """The cases cover every type the builder executes (the data layers
    and Input feed it: tests/test_torch_generic_train.py, Python:
    tests/test_torch_netbuilder.py), and the port lists what JAX lists."""
    assert TNB.layer_type_list() == JNB.layer_type_list()
    covered = {_case(c)[0].split('"')[1] for c in CASES}
    executed = set(TNB._BUILDER_TYPES) | set(TNB.ACTIVATIONS)
    assert executed - covered == {"Input", "Python"}
