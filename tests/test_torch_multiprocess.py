"""The port's ordered worker pool (``stylesinger_torch/utils/
multiprocess.py``) against the JAX package's, as ``tests/test_misc.py``
checks it: order in process, order in a pool, None for a job that
raised."""

from stylesinger_tpu.utils.multiprocess import multiprocess_run as jax_run

from stylesinger_torch.utils.multiprocess import multiprocess_run


def _square(x):
    return x * x


def _boom(x):
    raise RuntimeError("boom")


def test_multiprocess_run_inprocess_order():
    out = list(multiprocess_run(_square, [(i,) for i in range(6)],
                                num_workers=1))
    assert out == [(i, i * i) for i in range(6)]
    assert out == list(jax_run(_square, [(i,) for i in range(6)],
                               num_workers=1))


def test_multiprocess_run_pool_order():
    out = list(multiprocess_run(_square, [(i,) for i in range(8)],
                                num_workers=2))
    assert out == [(i, i * i) for i in range(8)]


def test_multiprocess_run_error_yields_none():
    assert list(multiprocess_run(_boom, [(1,)], num_workers=1)) == \
        [(0, None)]
    assert list(multiprocess_run(_boom, [(1,), (2,)], num_workers=2)) == \
        [(0, None), (1, None)]
