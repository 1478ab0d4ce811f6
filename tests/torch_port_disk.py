"""Disk use of the port's tests.

Several port tests write full-width weights, checkpoints and optimizer
states (hundreds of MB each) into pytest's temporary directories, and
pytest keeps the last three runs' of those: a whole run once left 9.1 GB
and filled the disk.  Such a test takes ``small_tmp_path`` in place of
``tmp_path``, and such a module fixture ends with ``tidy``: once the
test or the module is done, every file of ``LARGE`` bytes or more under
the directory is deleted, and the directory must then hold under
``MAX_LEFT`` bytes.  A test module imports the fixture::

    from torch_port_disk import small_tmp_path  # noqa: F401
"""

from __future__ import annotations

import os
import pathlib

import pytest

LARGE = 2 ** 20
MAX_LEFT = 50 * 2 ** 20


def _files(root: pathlib.Path):
    for parent, _, names in os.walk(root):
        for name in names:
            yield os.path.join(parent, name)


def tidy(root) -> None:
    """Delete every file of ``LARGE`` bytes or more under ``root``, then
    assert that what is left holds under ``MAX_LEFT`` bytes."""
    root = pathlib.Path(root)
    for path in list(_files(root)):
        if os.path.getsize(path) >= LARGE:
            os.unlink(path)
    held = sum(os.path.getsize(p) for p in _files(root))
    assert held < MAX_LEFT, f"{root} still holds {held / 2**20:.1f} MiB"


@pytest.fixture
def small_tmp_path(tmp_path):
    """``tmp_path``, tidied (``tidy``) once the test is done."""
    yield tmp_path
    tidy(tmp_path)
