"""The port's topology tables are exactly the JAX package's."""

import dataclasses

import numpy as np
import pytest

from srnn_tpu import topology as jtopo
from srnn_tpu_torch import topology as ttopo

SHAPES = [(2, 2), (3, 2), (2, 3), (1, 1), (4, 3)]
VARIANTS = ["weightwise", "aggregating", "fft", "recurrent"]


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("width,depth", SHAPES)
def test_tables_equal(variant, width, depth):
    jt = jtopo.Topology(variant, width=width, depth=depth)
    tt = ttopo.Topology(variant, width=width, depth=depth)
    assert tt.layer_shapes == jt.layer_shapes
    assert tt.offsets == jt.offsets
    assert tt.num_weights == jt.num_weights
    np.testing.assert_array_equal(ttopo.weight_coords(tt),
                                  jtopo.weight_coords(jt))
    a, b = ttopo.normalized_weight_coords(tt), jtopo.normalized_weight_coords(jt)
    assert a.dtype == b.dtype == np.float32
    np.testing.assert_array_equal(a, b)


def test_fields_and_validation_match():
    assert ([f.name for f in dataclasses.fields(ttopo.Topology)]
            == [f.name for f in dataclasses.fields(jtopo.Topology)])
    with pytest.raises(ValueError):
        ttopo.Topology("transformer")
    with pytest.raises(ValueError):
        ttopo.Topology("weightwise", width=0)
