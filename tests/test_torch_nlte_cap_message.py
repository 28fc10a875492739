"""The log line of an NLTE outer loop that the ``nlte_outer_iters`` cap
stopped: it names the cap, where the JAX package's dry run printed "NOT
converged" as if the solve had failed (ROADMAP Queue 3 "Dryrun message")."""

import os

import torch

import artis_tpu_torch.options as to
from artis_tpu_torch.synthdata import make_run

torch.set_num_threads(1)


def test_nlte_cap_is_named_in_the_log(tmp_path):
    from artis_tpu_torch.driver import Simulation

    d = str(tmp_path)
    make_run(d, ncells=4, ntimesteps=3, tmax_days=2.0, ngreyts=0, num_lte_timesteps=1)
    opts = to.nltenebular(npkts=200, grid_type=to.GridType.SPHERICAL1D, mintemp=1000.0,
                          maxtemp=20000.0, tablesize=12, nt_on=False,
                          nt_solve_spencerfano=False, nlte_outer_iters=1)
    sim = Simulation(d, opts, device="cpu")
    sim.do_timestep(0)
    sim.update_grid(1)
    sim.close()
    lines = [line for line in open(os.path.join(d, "output_0-0.txt"))
             if "NLTE outer loop" in line]
    assert len(lines) == 1
    fdmax = float(lines[0].split("max fracdiff ")[1].split()[0])
    assert fdmax > opts.nlte_convergence_tol
    assert lines[0].rstrip().endswith(
        f"after <= 1 iterations (stopped at the nlte_outer_iters cap (1), not converged to "
        f"{opts.nlte_convergence_tol})")
    assert "NOT converged" not in lines[0]
