"""Capture of file descriptor 2 while it is teed live to the real stderr.

Native code (CUDA, NCCL, the compiler) writes to fd 2 and bypasses
``sys.stderr``.  The capture is a live tee, not a redirect-then-replay:
a pump thread copies every chunk to the real stderr as it is written, so
a hard abort that skips Python's ``finally`` still leaves the log on the
console up to that moment (``transeditor_tpu/utils/capture.py``).
"""

from __future__ import annotations

import contextlib
import os
import sys
import threading


@contextlib.contextmanager
def capture_fd2(box: list):
    """Capture file descriptor 2 into ``box`` (a list; the text is
    appended as its last element) while live-teeing it to the real
    stderr."""
    sys.stderr.flush()
    saved = os.dup(2)
    r, w = os.pipe()
    chunks: list[bytes] = []

    def pump():
        while True:
            b = os.read(r, 65536)
            if not b:
                return
            chunks.append(b)
            # tee at the fd level: sys.stderr may be a replaced object
            # (pytest's capture) that no longer wraps fd 2.  If the real
            # stderr is gone, keep draining: a dead tee target must not
            # back up the pipe and block every fd-2 writer.
            try:
                os.write(saved, b)
            except OSError:
                pass

    t = threading.Thread(target=pump, daemon=True)
    t.start()
    try:
        os.dup2(w, 2)
        os.close(w)  # fd 2 is now the pipe's only write end
        yield
    finally:
        sys.stderr.flush()
        os.dup2(saved, 2)  # closes the last write end -> pump sees EOF
        t.join(timeout=10)
        if t.is_alive():
            # a subprocess inherited the write end and still holds it:
            # leave both fds to the thread rather than hand their numbers
            # to other code while it still reads
            print("capture_fd2: pump still draining (inherited fd 2 "
                  "write end?); leaving pipe open", file=sys.stderr)
        else:
            os.close(r)
            os.close(saved)
        box.append(b"".join(chunks).decode("utf-8", "replace"))
