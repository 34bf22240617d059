"""The port's side of ``tests/test_torch_prng.py``'s horizons: a program of
a case and its horizon run from ``PRNGKey(SEED)``, on one device or on this
rank of a mesh.  It imports no JAX (spawned gloo ranks import it)."""
import numpy as np

from repro_torch.configs import FLConfig
from repro_torch.core import prng
from repro_torch.core.volatility import CompletionLag, make_volatility, paper_success_rates
from repro_torch.engine import RoundProgram
from repro_torch.scenarios import make_scenario

SEED, T = 3, 8


def port_program(c, mesh):
    """The port's ``RoundProgram`` of a case (``test_torch_prng._case``)."""
    K = c["K"]
    if c["scenario"] in (None, "markov", "deadline"):
        rho = paper_success_rates(K)
        vol = make_volatility(c["scenario"] or "bernoulli", rho, seed=SEED, device="cpu")
    else:
        vol, rho = make_scenario(c["scenario"], K, T, SEED, device="cpu")
    if c["staleness"] is not None:
        vol = CompletionLag(vol, max_lag=c["staleness"])
    fl = FLConfig(K=K, k=c["k"], rounds=T, scheme=c["scheme"], sampler=c["sampler"], quota_frac=0.5,
                  allocator=c["allocator"])
    return RoundProgram(fl=fl, vol=vol, rho=rho, staleness=c["staleness"], alpha=0.5, mesh=mesh, fused=c["fused"],
                        device="cpu")


def horizon_rank(mesh, c):
    """This rank's full outputs of the case's horizon, its final counts and
    weights (slabs) and the key carried out."""
    pm = port_program(c, mesh)
    run, s0 = pm.build_runner(outputs="full", carry_key=True)
    key = prng.PRNGKey(SEED, "cpu")
    out = {}
    if c["staleness"] is None:
        st, key, masks, second, ps, _ = run(s0, key)
    else:
        st, key, _, masks, second, ps, _, arrived = run(s0, key, pm.init_rings())
        out["arrived"] = arrived.numpy()
    out.update(masks=masks.numpy(), second=second.numpy(), ps=ps.numpy(), key=np.asarray(key.data.numpy()),
               sel_counts=st.sel_counts.numpy(), logw=st.e3cs.logw.numpy())
    return out


def horizon_ranks(mesh, cases):
    """``horizon_rank`` of each case in turn on one group, each output
    named ``<case name>/<output>``."""
    return {f"{c['name']}/{n}": v for c in cases for n, v in horizon_rank(mesh, c).items()}
