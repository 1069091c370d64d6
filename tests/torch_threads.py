"""The port's test modules' shared fixture; it imports no JAX, so the
kernel tests that use it also run where JAX is not installed."""

import contextlib

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    """torch and the BLAS under numpy on one thread for the module. The
    suite runs in parallel workers on one CPU, and a pool of a thread per
    core in each of them oversubscribes it: at the tests' tiny widths the
    extra threads only spin, and slow the other workers' tests. Each port
    test module imports this fixture. Where ``threadpoolctl`` is not
    installed, only torch's pool is limited."""
    try:
        from threadpoolctl import threadpool_limits
    except ImportError:
        blas = contextlib.nullcontext()
    else:
        blas = threadpool_limits(limits=1)
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with blas:
            yield
    finally:
        torch.set_num_threads(before)


@pytest.fixture(scope="module")
def no_tensorflow():
    """TensorFlow unimportable for the module. The trainer logs to
    TensorBoard through ``torch.utils.tensorboard``, which imports
    TensorFlow where it is installed (seconds, and much memory, per
    worker) and its own stub where it is not. The training modules use
    this fixture so that they run as on a machine without TensorFlow."""
    import sys

    before = sys.modules.get("tensorflow", False)
    sys.modules["tensorflow"] = None
    try:
        yield
    finally:
        if before is False:
            del sys.modules["tensorflow"]
        else:
            sys.modules["tensorflow"] = before
