"""RecordIO-style chunked record format with a native C++ fast path
(port of paddle_tpu/recordio; Fluid's paddle/fluid/recordio and
recordio_writer.py). See recordio.cc for the on-disk layout, which both
packages and both paths here share.

API:
    with Writer(path, compress=True) as w:
        w.write(b"record bytes")
    for rec in Scanner(path):          # yields bytes
        ...
    reader = recordio_reader(path)     # paddle-style reader decorator
    write_recordio(path, iterable)     # bulk writer
"""

from paddle_tpu_torch.recordio.recordio import (
    PrefetchScanner, Scanner, Writer, count, native_available,
    native_error, prefetch_reader, recordio_reader, write_recordio)

__all__ = ["PrefetchScanner", "Scanner", "Writer", "count",
           "native_available", "native_error", "prefetch_reader",
           "recordio_reader", "write_recordio"]
