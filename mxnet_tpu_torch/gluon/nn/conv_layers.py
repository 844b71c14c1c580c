"""Convolution and pooling layers of the PyTorch port (reference:
gluon/nn/conv_layers.py): the counterpart of
``mxnet_tpu.gluon.nn.conv_layers`` over the ``Convolution``,
``Deconvolution`` and ``Pooling`` ops of ``mxnet_tpu_torch/ops/nn.py``.
"""
from __future__ import annotations

from ...base import MXNetError
from ..block import HybridBlock

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose",
           "Conv2DTranspose", "Conv3DTranspose",
           "MaxPool1D", "MaxPool2D", "MaxPool3D",
           "AvgPool1D", "AvgPool2D", "AvgPool3D",
           "GlobalMaxPool1D", "GlobalMaxPool2D", "GlobalMaxPool3D",
           "GlobalAvgPool1D", "GlobalAvgPool2D", "GlobalAvgPool3D",
           "ReflectionPad2D"]


def _tuplify(x, n):
    if isinstance(x, (list, tuple)):
        if len(x) != n:
            raise MXNetError(f"expected length-{n} tuple, got {x}")
        return tuple(x)
    return (x,) * n


class _Conv(HybridBlock):
    """Shared conv implementation (reference: gluon/nn/conv_layers._Conv)."""

    def __init__(self, channels, kernel_size, strides, padding, dilation,
                 groups, layout, in_channels=0, activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", ndim=2, transpose=False,
                 output_padding=0, **kwargs):
        super().__init__(**kwargs)
        self._channels = channels
        self._in_channels = in_channels
        self._kernel = _tuplify(kernel_size, ndim)
        self._strides = _tuplify(strides, ndim)
        self._padding = _tuplify(padding, ndim)
        self._dilation = _tuplify(dilation, ndim)
        self._groups = groups
        self._layout = layout
        self._activation = activation
        self._transpose = transpose
        self._output_padding = _tuplify(output_padding, ndim)
        if not layout.startswith("NC"):
            raise MXNetError(
                f"only NC* layouts supported, got {layout!r}")
        if transpose:
            wshape = (in_channels, channels // groups) + self._kernel
        else:
            wshape = (channels, in_channels // groups
                      if in_channels else 0) + self._kernel
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=wshape, init=weight_initializer,
                allow_deferred_init=True)
            if use_bias:
                self.bias = self.params.get(
                    "bias", shape=(channels,), init=bias_initializer,
                    allow_deferred_init=True)
            else:
                self.bias = None

    def infer_shape(self, x, *args):
        c_in = x.shape[1]
        if self._transpose:
            self.weight.shape = (c_in, self._channels // self._groups) \
                + self._kernel
        else:
            self.weight.shape = (self._channels, c_in // self._groups) \
                + self._kernel

    def hybrid_forward(self, F, x, weight, bias=None):
        if self._transpose:
            out = F.Deconvolution(
                x, weight, bias, kernel=self._kernel, stride=self._strides,
                dilate=self._dilation, pad=self._padding,
                adj=self._output_padding, num_filter=self._channels,
                num_group=self._groups, no_bias=bias is None)
        else:
            out = F.Convolution(
                x, weight, bias, kernel=self._kernel, stride=self._strides,
                dilate=self._dilation, pad=self._padding,
                num_filter=self._channels, num_group=self._groups,
                no_bias=bias is None)
        if self._activation is not None:
            out = F.Activation(out, act_type=self._activation)
        return out


class Conv1D(_Conv):
    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 dilation=1, groups=1, layout="NCW", activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, ndim=1,
                         **kwargs)


class Conv2D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 dilation=(1, 1), groups=1, layout="NCHW", activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, ndim=2,
                         **kwargs)


class Conv3D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), dilation=(1, 1, 1), groups=1,
                 layout="NCDHW", activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0, **kwargs):
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, ndim=3,
                         **kwargs)


class Conv1DTranspose(_Conv):
    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 output_padding=0, dilation=1, groups=1, layout="NCW",
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, ndim=1,
                         transpose=True, output_padding=output_padding,
                         **kwargs)


class Conv2DTranspose(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 output_padding=(0, 0), dilation=(1, 1), groups=1,
                 layout="NCHW", activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0, **kwargs):
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, ndim=2,
                         transpose=True, output_padding=output_padding,
                         **kwargs)


class Conv3DTranspose(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), output_padding=(0, 0, 0),
                 dilation=(1, 1, 1), groups=1, layout="NCDHW",
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, ndim=3,
                         transpose=True, output_padding=output_padding,
                         **kwargs)


class _Pooling(HybridBlock):
    def __init__(self, pool_size, strides, padding, ceil_mode, global_pool,
                 pool_type, ndim, count_include_pad=True, **kwargs):
        super().__init__(**kwargs)
        if strides is None:
            strides = pool_size
        self._kernel = _tuplify(pool_size, ndim)
        self._strides = _tuplify(strides, ndim)
        self._padding = _tuplify(padding, ndim)
        self._global = global_pool
        self._pool_type = pool_type
        self._convention = "full" if ceil_mode else "valid"
        self._count_include_pad = count_include_pad

    def hybrid_forward(self, F, x):
        return F.Pooling(
            x, kernel=self._kernel, pool_type=self._pool_type,
            stride=self._strides, pad=self._padding,
            global_pool=self._global, pooling_convention=self._convention,
            count_include_pad=self._count_include_pad)


class MaxPool1D(_Pooling):
    def __init__(self, pool_size=2, strides=None, padding=0, layout="NCW",
                 ceil_mode=False, **kwargs):
        super().__init__(pool_size, strides, padding, ceil_mode, False,
                         "max", 1, **kwargs)


class MaxPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, **kwargs):
        super().__init__(pool_size, strides, padding, ceil_mode, False,
                         "max", 2, **kwargs)


class MaxPool3D(_Pooling):
    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 layout="NCDHW", ceil_mode=False, **kwargs):
        super().__init__(pool_size, strides, padding, ceil_mode, False,
                         "max", 3, **kwargs)


class AvgPool1D(_Pooling):
    def __init__(self, pool_size=2, strides=None, padding=0, layout="NCW",
                 ceil_mode=False, count_include_pad=True, **kwargs):
        super().__init__(pool_size, strides, padding, ceil_mode, False,
                         "avg", 1, count_include_pad, **kwargs)


class AvgPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, count_include_pad=True,
                 **kwargs):
        super().__init__(pool_size, strides, padding, ceil_mode, False,
                         "avg", 2, count_include_pad, **kwargs)


class AvgPool3D(_Pooling):
    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 layout="NCDHW", ceil_mode=False, count_include_pad=True,
                 **kwargs):
        super().__init__(pool_size, strides, padding, ceil_mode, False,
                         "avg", 3, count_include_pad, **kwargs)


class GlobalMaxPool1D(_Pooling):
    def __init__(self, layout="NCW", **kwargs):
        super().__init__(1, None, 0, False, True, "max", 1, **kwargs)


class GlobalMaxPool2D(_Pooling):
    def __init__(self, layout="NCHW", **kwargs):
        super().__init__(1, None, 0, False, True, "max", 2, **kwargs)


class GlobalMaxPool3D(_Pooling):
    def __init__(self, layout="NCDHW", **kwargs):
        super().__init__(1, None, 0, False, True, "max", 3, **kwargs)


class GlobalAvgPool1D(_Pooling):
    def __init__(self, layout="NCW", **kwargs):
        super().__init__(1, None, 0, False, True, "avg", 1, **kwargs)


class GlobalAvgPool2D(_Pooling):
    def __init__(self, layout="NCHW", **kwargs):
        super().__init__(1, None, 0, False, True, "avg", 2, **kwargs)


class GlobalAvgPool3D(_Pooling):
    def __init__(self, layout="NCDHW", **kwargs):
        super().__init__(1, None, 0, False, True, "avg", 3, **kwargs)


class ReflectionPad2D(HybridBlock):
    """Reflection padding on H/W (reference: nn.ReflectionPad2D)."""

    def __init__(self, padding=0, **kwargs):
        super().__init__(**kwargs)
        if isinstance(padding, int):
            padding = (0, 0, 0, 0, padding, padding, padding, padding)
        self._padding = tuple(padding)

    def hybrid_forward(self, F, x):
        return F.pad(x, mode="reflect", pad_width=self._padding)
