"""The port's native host runtime (tcnn_tpu_torch/native.py, its library
built by g++ from tcnn_tpu_torch/csrc/host/tcnn_host.cpp) against
tcnn_tpu.native on the CPU, as tests/test_native.py holds tcnn_tpu's.

The port's library and its numpy fallback give the same streams bit for
bit: seeds, `next_uint`, `advance`, `uniform`, `logistic` and
`image_batch`, whose state advances by n after each batch (random.h:64-66).
Against tcnn_tpu.native every stream is bit-equal but `logistic`: the
port's copy of the library takes the logit's logarithm in double (so that
numpy reproduces it), tcnn_tpu's takes float logf or numpy's float32 log,
and the two differ in the last bit of about 1% of draws; held at
tests/test_native.py's rtol 2e-5, atol 1e-6. `uniform` is held against
tcnn_tpu at bounds whose difference is exact in f32: at others (0.1, 0.7)
tcnn_tpu's fallback rounds upper - lower from f64 where its library (and
the port's both routes) subtract in f32, and the two differ.
"""

import numpy as np
import pytest

import tcnn_tpu.native as jax_native
from tcnn_tpu.ops.pcg32 import _host_next, host_pcg32_init
from tcnn_tpu.utils.image import synthetic_image
from tcnn_tpu_torch import native

ROUTES = {"native": True, "fallback": False}


def bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


@pytest.fixture(scope="module")
def image():
    return np.ascontiguousarray(synthetic_image(48, 64), np.float32)


def test_library_builds_and_native_true_demands_it(monkeypatch):
    assert native.native_available()
    assert native.HostRng(1337, use_native=True)._native is not None
    assert native.HostRng(1337, use_native=False)._native is None
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_lib_error", "g++ not found")
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.HostRng(1337, use_native=True)
    assert native.HostRng(1337)._native is None  # None: the fallback, quietly


@pytest.mark.parametrize("route", ROUTES)
def test_seed_and_next_uint_match_the_oracle(route):
    r = native.HostRng(1337, use_native=ROUTES[route])
    state, inc = host_pcg32_init(1337)
    assert r.state == state == jax_native.HostRng(1337, use_native=False).state
    for _ in range(5):
        state, want = _host_next(state, inc)
        assert r.next_uint() == want
    r.advance(12345)
    j = jax_native.HostRng(1337, use_native=False)
    for _ in range(5):
        j.next_uint()
    j.advance(12345)
    assert r.state == j.state and r.next_uint() == j.next_uint()


@pytest.mark.parametrize("seed", [1337, 42])
def test_native_streams_equal_the_fallback_bit_for_bit(seed, image):
    a, b = (native.HostRng(seed, use_native=u) for u in (True, False))
    for n in (4096, 517):
        np.testing.assert_array_equal(bits(a.uniform(n, -2.0, 3.0)), bits(b.uniform(n, -2.0, 3.0)))
        np.testing.assert_array_equal(bits(a.uniform(n, 0.1, 0.7)), bits(b.uniform(n, 0.1, 0.7)))
        np.testing.assert_array_equal(bits(a.logistic(n, 0.5, 0.1)), bits(b.logistic(n, 0.5, 0.1)))
        assert a.state == b.state
    for xa, xb in zip(a.image_batch(image, 4096), b.image_batch(image, 4096)):
        np.testing.assert_array_equal(bits(xa), bits(xb))
    assert a.state == b.state


@pytest.mark.parametrize("route", ROUTES)
def test_streams_match_tcnn_tpu(route, image):
    r = native.HostRng(7, use_native=ROUTES[route])
    j = jax_native.HostRng(7)
    np.testing.assert_array_equal(bits(r.uniform(1000)), bits(j.uniform(1000)))
    np.testing.assert_array_equal(bits(r.uniform(517, -2.0, 3.0)), bits(j.uniform(517, -2.0, 3.0)))
    np.testing.assert_allclose(r.logistic(256, 0.5, 0.1), j.logistic(256, 0.5, 0.1),
                               rtol=2e-5, atol=1e-6)
    assert r.state == j.state
    for got, want in zip(r.image_batch(image, 2048), j.image_batch(image, 2048)):
        np.testing.assert_array_equal(bits(got), bits(want))


@pytest.mark.parametrize("route", ROUTES)
def test_sample_image_bilinear_matches_tcnn_tpu(route, image, monkeypatch):
    if not ROUTES[route]:
        monkeypatch.setattr(native, "_load", lambda: None)
    xy = jax_native.HostRng(3, use_native=False).uniform(2 * 333, -0.1, 1.1).reshape(-1, 2)
    got = native.sample_image_bilinear(image, xy)
    np.testing.assert_array_equal(bits(got), bits(jax_native.sample_image_bilinear(image, xy)))


def test_uniform_statistics_and_range():
    u = native.HostRng(3).uniform(4096, -2.0, 3.0)
    assert u.min() >= -2.0 and u.max() < 3.0
    assert abs(u.mean() - 0.5) < 0.1
