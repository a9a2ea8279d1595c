"""``exact_fp32`` across threads: a conditional-moment queue's producer
thread runs the first-moment model inside the context while the train
step runs inside it on the main thread. The TF32 flags are process-wide,
so they must stay off until the last open block exits, whichever thread
leaves first, and come back as they were before the first entry."""

import sys
import threading

import pytest
import torch

from sup3r_tpu_torch.utilities import exact_fp32


def _flags():
    return (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)


@pytest.fixture
def tf32_on():
    saved = _flags()
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def test_flags_stay_off_until_the_last_thread_exits(tf32_on):
    """A enters, B enters, A exits (B is mid-conv: the flags must stay
    off), then B exits and the flags come back."""
    a_in, b_in, a_out, b_go = (threading.Event() for _ in range(4))
    seen = {}

    def a():
        with exact_fp32():
            a_in.set()
            b_in.wait(10)
        a_out.set()

    def b():
        a_in.wait(10)
        with exact_fp32():
            b_in.set()
            a_out.wait(10)
            seen['b_after_a_left'] = _flags()
            b_go.wait(10)

    threads = [threading.Thread(target=f) for f in (a, b)]
    for t in threads:
        t.start()
    a_out.wait(10)
    seen['main_after_a_left'] = _flags()
    b_go.set()
    for t in threads:
        t.join(10)
    assert not any(t.is_alive() for t in threads)
    assert seen == {'b_after_a_left': (False, False),
                    'main_after_a_left': (False, False)}
    assert _flags() == (True, True)


def test_nested_and_raising_blocks_restore(tf32_on):
    with pytest.raises(RuntimeError):
        with exact_fp32():
            with exact_fp32():
                assert _flags() == (False, False)
            assert _flags() == (False, False)
            raise RuntimeError
    assert _flags() == (True, True)


def test_many_threads_keep_the_count(tf32_on):
    """16 threads entering and leaving many times with a short switch
    interval: inside a block the flags are always off, and afterwards
    they are back on."""
    bad = []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def work():
        for _ in range(200):
            with exact_fp32():
                if _flags() != (False, False):
                    bad.append(_flags())

    try:
        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not bad
    assert _flags() == (True, True)
