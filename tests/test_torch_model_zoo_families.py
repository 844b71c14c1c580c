"""PyTorch port, the vision model zoo against the JAX package: one
forward twin of each name of the zoo's table that
``tests/test_torch_model_zoo.py``'s twins of ``tests/test_models.py``
do not run (the DenseNets apart: that file says why), at 1x3x32x32
(AlexNet at 64x64), grouped by family so that the JAX package compiles
each family's shared operator shapes once.  Each model is built and
initialised in the port, its weights saved and loaded into the JAX
package's twin, and both logits compared within 1e-5 of max|logit|.
"""
import pytest

import mxnet_tpu_torch as mx

from test_torch_model_zoo import _twin

FAMILIES = {
    "resnet_v1": (["resnet34_v1", "resnet50_v1", "resnet101_v1",
                   "resnet152_v1"], 32),
    "resnet_v2": (["resnet34_v2", "resnet50_v2", "resnet101_v2",
                   "resnet152_v2"], 32),
    "vgg": (["vgg11", "vgg13", "vgg16", "vgg19"], 32),
    "alexnet_mobilenet": (["alexnet", "mobilenet1.0", "mobilenet0.5"], 64),
}


@pytest.fixture(autouse=True)
def _on_the_host():
    with mx.cpu(0):
        yield


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_model_zoo_family_forward(family, tmp_path):
    names, size = FAMILIES[family]
    for i, name in enumerate(names):
        out = _twin(name, (1, 3, size, size), tmp_path, seed=i, classes=10)
        assert out.shape == (1, 10)
