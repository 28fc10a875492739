"""One whole timestep of the port in expansion-opacity mode with
thermalisation probability 0.9 against the JAX package, on the CPU (the
check of tests/test_torch_expansion_timestep.py): a bin event thermalises
with that probability, re-emitted from the cell's Planck x kappa, and
scatters coherently otherwise."""

import torch

from test_torch_expansion_timestep import check_expansion_timestep

torch.set_num_threads(1)


def test_thermalised_timestep_matches_jax(tmp_path_factory):
    check_expansion_timestep(tmp_path_factory, 0.9)
