"""Composable reader decorators (the port's own copy of
paddle_tpu/data/readers.py, pure Python and numpy).

Capability-equivalent of Paddle's python/paddle/reader/decorator.py
(shuffle, chain, compose, buffered, firstn, map_readers, xmap_readers
multithreaded map, cache): the pipeline is generator composition on the
host, feeding an asynchronous device queue (data/feeder.py).

A "reader" is a zero-arg callable returning a fresh iterator over samples.
"""

from __future__ import annotations

import itertools
import queue
import random
import threading
from typing import Any, Callable, Iterator, List, Sequence

import numpy as np

Reader = Callable[[], Iterator[Any]]


def map_readers(func: Callable, *readers: Reader) -> Reader:
    """Apply func to items zipped from readers (decorator.py:36)."""
    def reader():
        for items in zip(*[r() for r in readers]):
            yield func(*items)
    return reader


def shuffle(reader: Reader, buf_size: int, seed: int = None) -> Reader:
    """Shuffle within a sliding buffer (decorator.py:62)."""
    def shuffled():
        rng = random.Random(seed)
        buf: List[Any] = []
        for item in reader():
            buf.append(item)
            if len(buf) >= buf_size:
                rng.shuffle(buf)
                for b in buf:
                    yield b
                buf = []
        if buf:
            rng.shuffle(buf)
            for b in buf:
                yield b
    return shuffled


def chain(*readers: Reader) -> Reader:
    """Concatenate readers sequentially (decorator.py:103)."""
    def chained():
        return itertools.chain(*[r() for r in readers])
    return chained


def compose(*readers: Reader, check_alignment: bool = True) -> Reader:
    """Zip readers into tuple samples (decorator.py:142)."""
    def make_tuple(x):
        return tuple(x) if isinstance(x, tuple) else (x,)

    def composed():
        its = [r() for r in readers]
        if check_alignment:
            for items in zip(*its):
                yield sum((make_tuple(i) for i in items), ())
        else:
            for items in itertools.zip_longest(*its):
                yield sum((make_tuple(i) for i in items if i is not None), ())
    return composed


def buffered(reader: Reader, size: int) -> Reader:
    """Background-thread prefetch buffer (decorator.py:191).

    The producer thread decouples data generation from consumption — the
    host-side half of the reference's double-buffer reader
    (operators/reader/create_double_buffer_reader_op.cc).
    """
    end = object()

    def buffered_reader():
        q: queue.Queue = queue.Queue(maxsize=size)
        err: List[BaseException] = []

        def produce():
            try:
                for item in reader():
                    q.put(item)
            except BaseException as e:  # propagate to consumer
                err.append(e)
            finally:
                q.put(end)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is end:
                if err:
                    raise err[0]
                return
            yield item
    return buffered_reader


def firstn(reader: Reader, n: int) -> Reader:
    """Limit to first n samples (decorator.py:231)."""
    def r():
        return itertools.islice(reader(), n)
    return r


def cache(reader: Reader) -> Reader:
    """Materialise once, then replay from memory (decorator.py: cache)."""
    data: List[Any] = []
    done = [False]

    def cached():
        if not done[0]:
            data.extend(reader())
            done[0] = True
        return iter(data)
    return cached


def xmap_readers(mapper: Callable, reader: Reader, process_num: int,
                 buffer_size: int, order: bool = False) -> Reader:
    """Multi-thread map over samples (decorator.py:283 XmapEndSignal flow).

    Threads (not processes): mappers are numpy-heavy and release the GIL;
    this matches the reference's thread pool.
    """
    end = object()

    def xreader():
        in_q: queue.Queue = queue.Queue(buffer_size)
        out_q: queue.Queue = queue.Queue(buffer_size)

        def feed():
            for i, sample in enumerate(reader()):
                in_q.put((i, sample))
            for _ in range(process_num):
                in_q.put(end)

        def work():
            while True:
                item = in_q.get()
                if item is end:
                    out_q.put(end)
                    return
                i, sample = item
                out_q.put((i, mapper(sample)))

        threads = [threading.Thread(target=feed, daemon=True)]
        threads += [threading.Thread(target=work, daemon=True)
                    for _ in range(process_num)]
        for t in threads:
            t.start()

        finished = 0
        if order:
            pending = {}
            want = 0
            while finished < process_num:
                item = out_q.get()
                if item is end:
                    finished += 1
                    continue
                i, mapped = item
                pending[i] = mapped
                while want in pending:
                    yield pending.pop(want)
                    want += 1
            for i in sorted(pending):
                yield pending[i]
        else:
            while finished < process_num:
                item = out_q.get()
                if item is end:
                    finished += 1
                    continue
                yield item[1]
    return xreader


def batch(reader: Reader, batch_size: int, drop_last: bool = True) -> Reader:
    """Group samples into batches (paddle.batch, python/paddle/batch.py)."""
    def batched():
        buf = []
        for sample in reader():
            buf.append(sample)
            if len(buf) == batch_size:
                yield _collate(buf)
                buf = []
        if buf and not drop_last:
            yield _collate(buf)
    return batched


def _collate(samples: Sequence[Any]):
    """Stack a list of samples into batched numpy arrays."""
    first = samples[0]
    if isinstance(first, (tuple, list)):
        return tuple(np.stack([np.asarray(s[i]) for s in samples])
                     for i in range(len(first)))
    if isinstance(first, dict):
        return {k: np.stack([np.asarray(s[k]) for s in samples])
                for k in first}
    return np.stack([np.asarray(s) for s in samples])
