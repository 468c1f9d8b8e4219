"""The layout of the port's test files.

The Tier-1 command runs the suite with ``-n 6 --dist loadfile``: each file is
one unit of work, and xdist queues the files by their number of tests, most
first (``--loadscope-reorder``, on by default), handing a worker its next
file only when two or fewer of its tests are still pending.
``tests/test_sharded.py`` holds 11 tests and runs for most of the Tier-1
limit by itself, so it has to start early: behind the seven larger files of
the JAX package's tests it is 8th in the queue and starts as soon as a
worker's first file is nearly done.  A port test file of more than 10 tests
would queue ahead of it and delay it by that file's run.  So no
``tests/test_torch_*.py`` file holds more than 10 tests.
"""
import collections

MAX_PORT_TESTS = 10
SHARDED = "tests/test_sharded.py"
SHARDED_PLACE = 8


def test_no_port_test_file_holds_more_than_ten_tests(request):
    """Counted from this session's own collection (parametrised cases each
    count); where the whole suite was collected, ``test_sharded.py`` is 8th
    in xdist's loadfile queue."""
    counts = collections.Counter(item.nodeid.split("::")[0] for item in request.session.items)
    port = {f: n for f, n in counts.items() if f.startswith("tests/test_torch_")}
    assert port and all(n <= MAX_PORT_TESTS for n in port.values()), {f: n for f, n in port.items() if n > MAX_PORT_TESTS}
    if SHARDED in counts:
        # xdist's order: by count, most first; a stable sort keeps ties in
        # collection order.
        queue = sorted(counts, key=lambda f: -counts[f])
        assert queue.index(SHARDED) + 1 == SHARDED_PLACE, queue[:SHARDED_PLACE]
