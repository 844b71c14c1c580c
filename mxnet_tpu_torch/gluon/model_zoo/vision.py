"""Vision model zoo of the PyTorch port (reference:
python/mxnet/gluon/model_zoo/vision/).

The counterpart of ``mxnet_tpu.gluon.model_zoo.vision``, built from the
port's ``gluon.nn`` layers with the same structure, so parameter names
and ``save_parameters`` files carry across: ResNet V1/V2 (basic and
bottleneck blocks), VGG, AlexNet, MobileNet V1/V2, SqueezeNet, DenseNet
and Inception V3 (over contrib ``HybridConcurrent``), NCHW.
``pretrained=True`` raises: there are no weights to download; load a
local file with ``load_parameters``.
"""
from __future__ import annotations

from ...base import MXNetError
from .. import nn
from ..block import HybridBlock

__all__ = ["get_model", "ResNetV1", "ResNetV2", "VGG", "AlexNet",
           "MobileNet", "MobileNetV2", "SqueezeNet", "DenseNet",
           "Inception3",
           "resnet18_v1", "resnet34_v1", "resnet50_v1", "resnet101_v1",
           "resnet152_v1", "resnet18_v2", "resnet34_v2", "resnet50_v2",
           "resnet101_v2", "resnet152_v2", "vgg11", "vgg13", "vgg16",
           "vgg19", "alexnet", "mobilenet1_0", "mobilenet0_5",
           "mobilenet_v2_1_0", "squeezenet1_0", "densenet121",
           "densenet161", "densenet169", "densenet201", "inception_v3"]

_NO_PRETRAINED = ("pretrained weights are not available; load a local "
                  ".params file with net.load_parameters instead")


# ---------------------------------------------------------------- ResNet V1
class BasicBlockV1(HybridBlock):
    """ResNet V1 basic block (reference: model_zoo/vision/resnet.py)."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 **kwargs):
        super().__init__(**kwargs)
        self.body = nn.HybridSequential(prefix="")
        self.body.add(nn.Conv2D(channels, 3, stride, 1,
                                in_channels=in_channels, use_bias=False))
        self.body.add(nn.BatchNorm())
        self.body.add(nn.Activation("relu"))
        self.body.add(nn.Conv2D(channels, 3, 1, 1, in_channels=channels,
                                use_bias=False))
        self.body.add(nn.BatchNorm())
        if downsample:
            self.downsample = nn.HybridSequential(prefix="")
            self.downsample.add(nn.Conv2D(channels, 1, stride,
                                          in_channels=in_channels,
                                          use_bias=False))
            self.downsample.add(nn.BatchNorm())
        else:
            self.downsample = None

    def hybrid_forward(self, F, x):
        residual = x
        x = self.body(x)
        if self.downsample is not None:
            residual = self.downsample(residual)
        return F.Activation(x + residual, act_type="relu")


class BottleneckV1(HybridBlock):
    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 **kwargs):
        super().__init__(**kwargs)
        self.body = nn.HybridSequential(prefix="")
        self.body.add(nn.Conv2D(channels // 4, 1, stride,
                                in_channels=in_channels, use_bias=False))
        self.body.add(nn.BatchNorm())
        self.body.add(nn.Activation("relu"))
        self.body.add(nn.Conv2D(channels // 4, 3, 1, 1,
                                in_channels=channels // 4, use_bias=False))
        self.body.add(nn.BatchNorm())
        self.body.add(nn.Activation("relu"))
        self.body.add(nn.Conv2D(channels, 1, 1, in_channels=channels // 4,
                                use_bias=False))
        self.body.add(nn.BatchNorm())
        if downsample:
            self.downsample = nn.HybridSequential(prefix="")
            self.downsample.add(nn.Conv2D(channels, 1, stride,
                                          in_channels=in_channels,
                                          use_bias=False))
            self.downsample.add(nn.BatchNorm())
        else:
            self.downsample = None

    def hybrid_forward(self, F, x):
        residual = x
        x = self.body(x)
        if self.downsample is not None:
            residual = self.downsample(residual)
        return F.Activation(x + residual, act_type="relu")


class BasicBlockV2(HybridBlock):
    """Pre-activation block (reference: resnet.py BasicBlockV2)."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 **kwargs):
        super().__init__(**kwargs)
        self.bn1 = nn.BatchNorm()
        self.conv1 = nn.Conv2D(channels, 3, stride, 1,
                               in_channels=in_channels, use_bias=False)
        self.bn2 = nn.BatchNorm()
        self.conv2 = nn.Conv2D(channels, 3, 1, 1, in_channels=channels,
                               use_bias=False)
        if downsample:
            self.downsample = nn.Conv2D(channels, 1, stride,
                                        in_channels=in_channels,
                                        use_bias=False)
        else:
            self.downsample = None

    def hybrid_forward(self, F, x):
        residual = x
        x = self.bn1(x)
        x = F.Activation(x, act_type="relu")
        if self.downsample is not None:
            residual = self.downsample(x)
        x = self.conv1(x)
        x = self.bn2(x)
        x = F.Activation(x, act_type="relu")
        x = self.conv2(x)
        return x + residual


class BottleneckV2(HybridBlock):
    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 **kwargs):
        super().__init__(**kwargs)
        self.bn1 = nn.BatchNorm()
        self.conv1 = nn.Conv2D(channels // 4, 1, 1, use_bias=False)
        self.bn2 = nn.BatchNorm()
        self.conv2 = nn.Conv2D(channels // 4, 3, stride, 1, use_bias=False)
        self.bn3 = nn.BatchNorm()
        self.conv3 = nn.Conv2D(channels, 1, 1, use_bias=False)
        if downsample:
            self.downsample = nn.Conv2D(channels, 1, stride,
                                        use_bias=False)
        else:
            self.downsample = None

    def hybrid_forward(self, F, x):
        residual = x
        x = self.bn1(x)
        x = F.Activation(x, act_type="relu")
        if self.downsample is not None:
            residual = self.downsample(x)
        x = self.conv1(x)
        x = self.bn2(x)
        x = F.Activation(x, act_type="relu")
        x = self.conv2(x)
        x = self.bn3(x)
        x = F.Activation(x, act_type="relu")
        x = self.conv3(x)
        return x + residual


class ResNetV1(HybridBlock):
    def __init__(self, block, layers, channels, classes=1000,
                 thumbnail=False, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            if thumbnail:
                self.features.add(nn.Conv2D(channels[0], 3, 1, 1,
                                            use_bias=False))
            else:
                self.features.add(nn.Conv2D(channels[0], 7, 2, 3,
                                            use_bias=False))
                self.features.add(nn.BatchNorm())
                self.features.add(nn.Activation("relu"))
                self.features.add(nn.MaxPool2D(3, 2, 1))
            for i, num_layer in enumerate(layers):
                stride = 1 if i == 0 else 2
                self.features.add(self._make_layer(
                    block, num_layer, channels[i + 1], stride, i + 1,
                    in_channels=channels[i]))
            self.features.add(nn.GlobalAvgPool2D())
            self.output = nn.Dense(classes, in_units=channels[-1])

    def _make_layer(self, block, layers, channels, stride, stage_index,
                    in_channels=0):
        layer = nn.HybridSequential(prefix=f"stage{stage_index}_")
        with layer.name_scope():
            layer.add(block(channels, stride, channels != in_channels,
                            in_channels=in_channels, prefix=""))
            for _ in range(layers - 1):
                layer.add(block(channels, 1, False, in_channels=channels,
                                prefix=""))
        return layer

    def hybrid_forward(self, F, x):
        x = self.features(x)
        return self.output(F.flatten(x))


class ResNetV2(HybridBlock):
    def __init__(self, block, layers, channels, classes=1000,
                 thumbnail=False, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            self.features.add(nn.BatchNorm(scale=False, center=False))
            if thumbnail:
                self.features.add(nn.Conv2D(channels[0], 3, 1, 1,
                                            use_bias=False))
            else:
                self.features.add(nn.Conv2D(channels[0], 7, 2, 3,
                                            use_bias=False))
                self.features.add(nn.BatchNorm())
                self.features.add(nn.Activation("relu"))
                self.features.add(nn.MaxPool2D(3, 2, 1))
            in_channels = channels[0]
            for i, num_layer in enumerate(layers):
                stride = 1 if i == 0 else 2
                self.features.add(self._make_layer(
                    block, num_layer, channels[i + 1], stride, i + 1,
                    in_channels=in_channels))
                in_channels = channels[i + 1]
            self.features.add(nn.BatchNorm())
            self.features.add(nn.Activation("relu"))
            self.features.add(nn.GlobalAvgPool2D())
            self.features.add(nn.Flatten())
            self.output = nn.Dense(classes, in_units=in_channels)

    _make_layer = ResNetV1._make_layer

    def hybrid_forward(self, F, x):
        x = self.features(x)
        return self.output(x)


_RESNET_SPEC = {
    18: ("basic_block", [2, 2, 2, 2], [64, 64, 128, 256, 512]),
    34: ("basic_block", [3, 4, 6, 3], [64, 64, 128, 256, 512]),
    50: ("bottle_neck", [3, 4, 6, 3], [64, 256, 512, 1024, 2048]),
    101: ("bottle_neck", [3, 4, 23, 3], [64, 256, 512, 1024, 2048]),
    152: ("bottle_neck", [3, 8, 36, 3], [64, 256, 512, 1024, 2048]),
}
_RESNET_NET = {1: ResNetV1, 2: ResNetV2}
_RESNET_BLOCK = {1: {"basic_block": BasicBlockV1,
                     "bottle_neck": BottleneckV1},
                 2: {"basic_block": BasicBlockV2,
                     "bottle_neck": BottleneckV2}}


def get_resnet(version, num_layers, pretrained=False, classes=1000,
               **kwargs):
    if pretrained:
        raise MXNetError(_NO_PRETRAINED)
    block_type, layers, channels = _RESNET_SPEC[num_layers]
    net_cls = _RESNET_NET[version]
    block_cls = _RESNET_BLOCK[version][block_type]
    return net_cls(block_cls, layers, channels, classes=classes, **kwargs)


def resnet18_v1(**kw):
    return get_resnet(1, 18, **kw)


def resnet34_v1(**kw):
    return get_resnet(1, 34, **kw)


def resnet50_v1(**kw):
    return get_resnet(1, 50, **kw)


def resnet101_v1(**kw):
    return get_resnet(1, 101, **kw)


def resnet152_v1(**kw):
    return get_resnet(1, 152, **kw)


def resnet18_v2(**kw):
    return get_resnet(2, 18, **kw)


def resnet34_v2(**kw):
    return get_resnet(2, 34, **kw)


def resnet50_v2(**kw):
    return get_resnet(2, 50, **kw)


def resnet101_v2(**kw):
    return get_resnet(2, 101, **kw)


def resnet152_v2(**kw):
    return get_resnet(2, 152, **kw)


# -------------------------------------------------------------------- VGG
class VGG(HybridBlock):
    def __init__(self, layers, filters, classes=1000, batch_norm=False,
                 **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            for i, num in enumerate(layers):
                for _ in range(num):
                    self.features.add(nn.Conv2D(filters[i], 3, 1, 1))
                    if batch_norm:
                        self.features.add(nn.BatchNorm())
                    self.features.add(nn.Activation("relu"))
                self.features.add(nn.MaxPool2D(2, 2))
            self.features.add(nn.Flatten())
            self.features.add(nn.Dense(4096, activation="relu"))
            self.features.add(nn.Dropout(0.5))
            self.features.add(nn.Dense(4096, activation="relu"))
            self.features.add(nn.Dropout(0.5))
            self.output = nn.Dense(classes)

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


_VGG_SPEC = {11: ([1, 1, 2, 2, 2], [64, 128, 256, 512, 512]),
             13: ([2, 2, 2, 2, 2], [64, 128, 256, 512, 512]),
             16: ([2, 2, 3, 3, 3], [64, 128, 256, 512, 512]),
             19: ([2, 2, 4, 4, 4], [64, 128, 256, 512, 512])}


def get_vgg(num_layers, pretrained=False, **kwargs):
    if pretrained:
        raise MXNetError(_NO_PRETRAINED)
    layers, filters = _VGG_SPEC[num_layers]
    return VGG(layers, filters, **kwargs)


def vgg11(**kw):
    return get_vgg(11, **kw)


def vgg13(**kw):
    return get_vgg(13, **kw)


def vgg16(**kw):
    return get_vgg(16, **kw)


def vgg19(**kw):
    return get_vgg(19, **kw)


# ----------------------------------------------------------------- AlexNet
class AlexNet(HybridBlock):
    def __init__(self, classes=1000, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            self.features.add(nn.Conv2D(64, 11, 4, 2, activation="relu"))
            self.features.add(nn.MaxPool2D(3, 2))
            self.features.add(nn.Conv2D(192, 5, padding=2,
                                        activation="relu"))
            self.features.add(nn.MaxPool2D(3, 2))
            self.features.add(nn.Conv2D(384, 3, padding=1,
                                        activation="relu"))
            self.features.add(nn.Conv2D(256, 3, padding=1,
                                        activation="relu"))
            self.features.add(nn.Conv2D(256, 3, padding=1,
                                        activation="relu"))
            self.features.add(nn.MaxPool2D(3, 2))
            self.features.add(nn.Flatten())
            self.features.add(nn.Dense(4096, activation="relu"))
            self.features.add(nn.Dropout(0.5))
            self.features.add(nn.Dense(4096, activation="relu"))
            self.features.add(nn.Dropout(0.5))
            self.output = nn.Dense(classes)

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def alexnet(pretrained=False, **kw):
    if pretrained:
        raise MXNetError(_NO_PRETRAINED)
    return AlexNet(**kw)


# --------------------------------------------------------------- MobileNet
def _add_conv(out, channels=1, kernel=1, stride=1, pad=0, num_group=1,
              active=True, relu6=False):
    out.add(nn.Conv2D(channels, kernel, stride, pad, groups=num_group,
                      use_bias=False))
    out.add(nn.BatchNorm())
    if active:
        out.add(nn.Lambda(lambda x: x.clip(0, 6)) if relu6
                else nn.Activation("relu"))


class MobileNet(HybridBlock):
    """MobileNet V1 (reference: model_zoo/vision/mobilenet.py)."""

    def __init__(self, multiplier=1.0, classes=1000, **kwargs):
        super().__init__(**kwargs)
        dw_channels = [int(x * multiplier) for x in
                       [32, 64] + [128] * 2 + [256] * 2 + [512] * 6 + [1024]]
        channels = [int(x * multiplier) for x in
                    [64] + [128] * 2 + [256] * 2 + [512] * 6 + [1024] * 2]
        strides = [1, 2] * 3 + [1] * 5 + [2, 1]
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            _add_conv(self.features, int(32 * multiplier), 3, 2, 1)
            for dwc, c, s in zip(dw_channels, channels, strides):
                _add_conv(self.features, dwc, 3, s, 1, num_group=dwc)
                _add_conv(self.features, c)
            self.features.add(nn.GlobalAvgPool2D())
            self.features.add(nn.Flatten())
            self.output = nn.Dense(classes)

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


class LinearBottleneck(HybridBlock):
    def __init__(self, in_channels, channels, t, stride, **kwargs):
        super().__init__(**kwargs)
        self.use_shortcut = stride == 1 and in_channels == channels
        with self.name_scope():
            self.out = nn.HybridSequential()
            _add_conv(self.out, in_channels * t, relu6=True)
            _add_conv(self.out, in_channels * t, 3, stride, 1,
                      num_group=in_channels * t, relu6=True)
            _add_conv(self.out, channels, active=False)

    def hybrid_forward(self, F, x):
        out = self.out(x)
        if self.use_shortcut:
            out = out + x
        return out


class MobileNetV2(HybridBlock):
    def __init__(self, multiplier=1.0, classes=1000, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="features_")
            with self.features.name_scope():
                _add_conv(self.features, int(32 * multiplier), 3, 2, 1,
                          relu6=True)
                in_ch = [int(multiplier * x) for x in
                         [32] + [16] + [24] * 2 + [32] * 3 + [64] * 4
                         + [96] * 3 + [160] * 3]
                ch = [int(multiplier * x) for x in
                      [16] + [24] * 2 + [32] * 3 + [64] * 4 + [96] * 3
                      + [160] * 3 + [320]]
                ts = [1] + [6] * 16
                strides = [1, 2] * 2 + [1, 1, 2] + [1] * 6 + [2] + [1] * 3
                for i, c, t, s in zip(in_ch, ch, ts, strides):
                    self.features.add(LinearBottleneck(i, c, t, s))
                last = int(1280 * multiplier) if multiplier > 1.0 else 1280
                _add_conv(self.features, last, relu6=True)
                self.features.add(nn.GlobalAvgPool2D())
            self.output = nn.HybridSequential(prefix="output_")
            with self.output.name_scope():
                self.output.add(nn.Conv2D(classes, 1, use_bias=False,
                                          prefix="pred_"))
                self.output.add(nn.Flatten())

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def mobilenet1_0(**kw):
    return MobileNet(1.0, **kw)


def mobilenet0_5(**kw):
    return MobileNet(0.5, **kw)


def mobilenet_v2_1_0(**kw):
    return MobileNetV2(1.0, **kw)


# -------------------------------------------------------------- SqueezeNet
class _FireBlock(HybridBlock):
    def __init__(self, squeeze, expand1x1, expand3x3, **kwargs):
        super().__init__(**kwargs)
        self.squeeze = nn.Conv2D(squeeze, 1, activation="relu")
        self.expand1 = nn.Conv2D(expand1x1, 1, activation="relu")
        self.expand3 = nn.Conv2D(expand3x3, 3, padding=1, activation="relu")

    def hybrid_forward(self, F, x):
        x = self.squeeze(x)
        return F.concat(self.expand1(x), self.expand3(x), dim=1)


class SqueezeNet(HybridBlock):
    def __init__(self, version="1.0", classes=1000, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            self.features.add(nn.Conv2D(96, 7, 2, activation="relu"))
            self.features.add(nn.MaxPool2D(3, 2, ceil_mode=True))
            for sq, e1, e3 in [(16, 64, 64), (16, 64, 64), (32, 128, 128)]:
                self.features.add(_FireBlock(sq, e1, e3))
            self.features.add(nn.MaxPool2D(3, 2, ceil_mode=True))
            for sq, e1, e3 in [(32, 128, 128), (48, 192, 192),
                               (48, 192, 192), (64, 256, 256)]:
                self.features.add(_FireBlock(sq, e1, e3))
            self.features.add(nn.MaxPool2D(3, 2, ceil_mode=True))
            self.features.add(_FireBlock(64, 256, 256))
            self.features.add(nn.Dropout(0.5))
            self.output = nn.HybridSequential(prefix="")
            self.output.add(nn.Conv2D(classes, 1, activation="relu"))
            self.output.add(nn.GlobalAvgPool2D())
            self.output.add(nn.Flatten())

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def squeezenet1_0(**kw):
    return SqueezeNet("1.0", **kw)


# ---------------------------------------------------------------- DenseNet
class _DenseLayer(HybridBlock):
    """BN→ReLU→1x1→BN→ReLU→3x3, output concatenated onto the input
    (reference: model_zoo/vision/densenet.py _make_dense_layer)."""

    def __init__(self, growth_rate, bn_size, dropout, **kwargs):
        super().__init__(**kwargs)
        self.body = nn.HybridSequential(prefix="")
        self.body.add(nn.BatchNorm(), nn.Activation("relu"),
                      nn.Conv2D(bn_size * growth_rate, 1, use_bias=False),
                      nn.BatchNorm(), nn.Activation("relu"),
                      nn.Conv2D(growth_rate, 3, padding=1, use_bias=False))
        self.dropout = nn.Dropout(dropout) if dropout else None

    def hybrid_forward(self, F, x):
        out = self.body(x)
        if self.dropout is not None:
            out = self.dropout(out)
        return F.concat(x, out, dim=1)


def _transition(channels):
    out = nn.HybridSequential(prefix="")
    out.add(nn.BatchNorm(), nn.Activation("relu"),
            nn.Conv2D(channels, 1, use_bias=False), nn.AvgPool2D(2, 2))
    return out


_DENSENET_SPEC = {121: (64, 32, [6, 12, 24, 16]),
                  161: (96, 48, [6, 12, 36, 24]),
                  169: (64, 32, [6, 12, 32, 32]),
                  201: (64, 32, [6, 12, 48, 32])}


class DenseNet(HybridBlock):
    """DenseNet-BC (reference: model_zoo/vision/densenet.py)."""

    def __init__(self, num_init_features, growth_rate, block_config,
                 bn_size=4, dropout=0, classes=1000, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            self.features.add(
                nn.Conv2D(num_init_features, 7, 2, 3, use_bias=False),
                nn.BatchNorm(), nn.Activation("relu"),
                nn.MaxPool2D(3, 2, 1))
            channels = num_init_features
            for i, n_layers in enumerate(block_config):
                for _ in range(n_layers):
                    self.features.add(_DenseLayer(growth_rate, bn_size,
                                                  dropout))
                    channels += growth_rate
                if i != len(block_config) - 1:
                    channels //= 2
                    self.features.add(_transition(channels))
            self.features.add(nn.BatchNorm(), nn.Activation("relu"),
                              nn.GlobalAvgPool2D(), nn.Flatten())
            self.output = nn.Dense(classes)

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def _densenet(num_layers, **kw):
    if kw.pop("pretrained", False):
        raise MXNetError(_NO_PRETRAINED)
    init_f, growth, cfg = _DENSENET_SPEC[num_layers]
    return DenseNet(init_f, growth, cfg, **kw)


def densenet121(**kw):
    return _densenet(121, **kw)


def densenet161(**kw):
    return _densenet(161, **kw)


def densenet169(**kw):
    return _densenet(169, **kw)


def densenet201(**kw):
    return _densenet(201, **kw)


# ------------------------------------------------------------ Inception V3
def _inc_conv(channels, kernel, stride=1, padding=0):
    out = nn.HybridSequential(prefix="")
    out.add(nn.Conv2D(channels, kernel, stride, padding, use_bias=False),
            nn.BatchNorm(epsilon=0.001), nn.Activation("relu"))
    return out


def _IncBranches(branches):
    """Parallel branches concatenated on channels (the reference's
    inception.py builds them from contrib HybridConcurrent)."""
    from ..contrib.nn import HybridConcurrent
    out = HybridConcurrent(axis=1)
    out.add(*branches)
    return out


def _seq(*blocks):
    out = nn.HybridSequential(prefix="")
    out.add(*blocks)
    return out


def _inc_a(pool_features):
    return _IncBranches([
        _inc_conv(64, 1),
        _seq(_inc_conv(48, 1), _inc_conv(64, 5, padding=2)),
        _seq(_inc_conv(64, 1), _inc_conv(96, 3, padding=1),
             _inc_conv(96, 3, padding=1)),
        _seq(nn.AvgPool2D(3, 1, 1), _inc_conv(pool_features, 1))])


def _inc_b():
    return _IncBranches([
        _inc_conv(384, 3, 2),
        _seq(_inc_conv(64, 1), _inc_conv(96, 3, padding=1),
             _inc_conv(96, 3, 2)),
        nn.MaxPool2D(3, 2)])


def _inc_c(c7):
    return _IncBranches([
        _inc_conv(192, 1),
        _seq(_inc_conv(c7, 1), _inc_conv(c7, (1, 7), padding=(0, 3)),
             _inc_conv(192, (7, 1), padding=(3, 0))),
        _seq(_inc_conv(c7, 1), _inc_conv(c7, (7, 1), padding=(3, 0)),
             _inc_conv(c7, (1, 7), padding=(0, 3)),
             _inc_conv(c7, (7, 1), padding=(3, 0)),
             _inc_conv(192, (1, 7), padding=(0, 3))),
        _seq(nn.AvgPool2D(3, 1, 1), _inc_conv(192, 1))])


def _inc_d():
    return _IncBranches([
        _seq(_inc_conv(192, 1), _inc_conv(320, 3, 2)),
        _seq(_inc_conv(192, 1), _inc_conv(192, (1, 7), padding=(0, 3)),
             _inc_conv(192, (7, 1), padding=(3, 0)), _inc_conv(192, 3, 2)),
        nn.MaxPool2D(3, 2)])


def _inc_e():
    return _IncBranches([
        _inc_conv(320, 1),
        _seq(_inc_conv(384, 1),
             _IncBranches([_inc_conv(384, (1, 3), padding=(0, 1)),
                           _inc_conv(384, (3, 1), padding=(1, 0))])),
        _seq(_inc_conv(448, 1), _inc_conv(384, 3, padding=1),
             _IncBranches([_inc_conv(384, (1, 3), padding=(0, 1)),
                           _inc_conv(384, (3, 1), padding=(1, 0))])),
        _seq(nn.AvgPool2D(3, 1, 1), _inc_conv(192, 1))])


class Inception3(HybridBlock):
    """Inception V3, 299x299 input (reference:
    model_zoo/vision/inception.py)."""

    def __init__(self, classes=1000, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            self.features.add(
                _inc_conv(32, 3, 2), _inc_conv(32, 3), _inc_conv(64, 3,
                                                                 padding=1),
                nn.MaxPool2D(3, 2),
                _inc_conv(80, 1), _inc_conv(192, 3), nn.MaxPool2D(3, 2),
                _inc_a(32), _inc_a(64), _inc_a(64),
                _inc_b(),
                _inc_c(128), _inc_c(160), _inc_c(160), _inc_c(192),
                _inc_d(),
                _inc_e(), _inc_e(),
                nn.AvgPool2D(8), nn.Dropout(0.5))
            self.output = nn.Dense(classes)

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def inception_v3(pretrained=False, **kw):
    if pretrained:
        raise MXNetError(_NO_PRETRAINED)
    return Inception3(**kw)


_MODELS = {
    "resnet18_v1": resnet18_v1, "resnet34_v1": resnet34_v1,
    "resnet50_v1": resnet50_v1, "resnet101_v1": resnet101_v1,
    "resnet152_v1": resnet152_v1,
    "resnet18_v2": resnet18_v2, "resnet34_v2": resnet34_v2,
    "resnet50_v2": resnet50_v2, "resnet101_v2": resnet101_v2,
    "resnet152_v2": resnet152_v2,
    "vgg11": vgg11, "vgg13": vgg13, "vgg16": vgg16, "vgg19": vgg19,
    "alexnet": alexnet,
    "mobilenet1.0": mobilenet1_0, "mobilenet0.5": mobilenet0_5,
    "mobilenetv2_1.0": mobilenet_v2_1_0,
    "squeezenet1.0": squeezenet1_0,
    "densenet121": densenet121, "densenet161": densenet161,
    "densenet169": densenet169, "densenet201": densenet201,
    "inceptionv3": inception_v3,
}


def get_model(name, **kwargs):
    """Reference: model_zoo.vision.get_model."""
    name = name.lower()
    if name not in _MODELS:
        raise MXNetError(
            f"unknown model {name!r}; available: {sorted(_MODELS)}")
    return _MODELS[name](**kwargs)
