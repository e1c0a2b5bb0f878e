"""Subprocess body of the port's distributed parity tests: the reference
package's two-pass programs on P fake host devices.

    python tests/_distributed_ref_runner.py P OUT.npz

Runs ``make_distributed_two_pass_multi`` and ``make_distributed_two_pass``
(continuous, ``L_SINGLE``) with each merge over ``_two_pass_case.stream(P)``
and writes device 0's copy of every output to OUT.npz.  Sets ``XLA_FLAGS``
itself, so it must run in its own process.
"""
import os
import sys
from pathlib import Path

P = int(sys.argv[1])
os.environ["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={P}"

import jax  # noqa: E402
import numpy as np  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _two_pass_case as case  # noqa: E402
from repro.core import distributed as DD  # noqa: E402


def _mesh():
    try:  # AxisType landed after jax 0.4; default axis types are equivalent
        from jax.sharding import AxisType

        return jax.make_mesh((P,), ("data",), axis_types=(AxisType.Auto,))
    except ImportError:
        return jax.make_mesh((P,), ("data",))


def main(out: str) -> None:
    assert len(jax.devices()) == P
    mesh = _mesh()
    keys, weights = case.stream(P)
    res = {}
    for merge in case.MERGES:
        multi = DD.make_distributed_two_pass_multi(
            mesh, ls=case.LS, salt=case.SALT, k=case.K, chunk=case.CHUNK,
            merge=merge)
        single = DD.make_distributed_two_pass(
            mesh, kind="continuous", l=case.L_SINGLE, salt=case.SALT, k=case.K,
            chunk=case.CHUNK, merge=merge)
        for prog, out_ in (("multi", multi(keys, weights)),
                           ("single", single(keys, weights))):
            for name, a in zip(("keys", "seeds", "weights"), out_):
                res[f"{prog}_{merge}_{name}"] = np.asarray(a)[0]
    np.savez(out, **res)


if __name__ == "__main__":
    main(sys.argv[2])
