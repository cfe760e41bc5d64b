"""Sharding specs of the training state and the batch.

The first three functions of ``repro.launch.dryrun`` (``_dp_axis``,
``batch_specs``, ``opt_state_specs``), which the elastic restart
(:mod:`repro_torch.launch.elastic_restart`) and the mesh-sharded train
step use.  The rest of the reference's dry run (lowering every arch ×
shape × mesh cell for 256 and 512 devices, the cache specs, the roofline
report) is ROADMAP.md's Queue 1, a later slice.
"""

from __future__ import annotations

from repro_torch.dist.sharding import P, map_specs, sanitize_spec
from repro_torch.models.layers import tree_map


def _dp_axis(rules):
    return rules["batch"]


def batch_specs(batch_avals, rules, mesh):
    """A spec for each batch leaf: the leading (batch) dim over the dp axes,
    sanitized against its shape."""
    dp = _dp_axis(rules)

    def spec(a):
        parts = [dp] + [None] * (len(a.shape) - 1)
        return sanitize_spec(P(*parts), a.shape, mesh)

    return tree_map(spec, batch_avals)


def opt_state_specs(opt_state_avals, params_specs, mesh):
    """Moments inherit param specs; factored/absent dims fall back cleanly.

    Covers the port's ``AdamWState`` (``mu``, ``nu``) and
    ``AdafactorState`` (``vr``, ``vc``); ``step`` replicates.  Each moment
    leaf takes its parameter's spec cut to its own rank, sanitized
    against its shape.
    """

    def for_moment_tree(tree_avals):
        return map_specs(lambda s, a: sanitize_spec(P(*list(s)[: len(a.shape)]), a.shape, mesh),
                         params_specs, tree_avals)

    if hasattr(opt_state_avals, "mu"):
        return type(opt_state_avals)(
            step=P(),
            mu=for_moment_tree(opt_state_avals.mu),
            nu=for_moment_tree(opt_state_avals.nu),
        )
    # Adafactor
    return type(opt_state_avals)(
        step=P(),
        vr=for_moment_tree(opt_state_avals.vr),
        vc=for_moment_tree(opt_state_avals.vc),
    )
