"""Seeds 1 and 2 of ``test_torch_port_ranger.py``'s Ranger-against-optax
run over the reduced encoder's whole tree (the docstring there says
what is held, and why), on a worker of their own."""

import pytest

import torch_port_encoder_oracle as orc
from torch_port_ranger_oracle import run_seed
from torch_port_threads import torch_worker_threads  # noqa: F401


@pytest.mark.parametrize("seed", orc.SEEDS[1:])
def test_ranger_matches_optax_on_the_encoder_tree(seed):
    """``ranger_simple`` and ``ranger`` (Lookahead) side by side, each
    against its optax counterpart (jitted, as the JAX coach runs it), on
    the same 20 gradients."""
    run_seed(seed)
