"""NaN-safe transcendental wrappers (the where-NaN gradient trap).

NaN is the library's universal missing-value sentinel (SURVEY/reference
contract), and every *selection* op (``jnp.where``, masked reductions) has a
clean backward rule: masked-out positions get a zero cotangent.  But ops
whose backward rule *multiplies or divides by forward values* — ``exp``
(cot·e^x), ``log`` (cot/x), powers, even plain multiplication — turn that
zero cotangent into ``0·NaN = NaN`` whenever the forward value was NaN, and
the poison then spreads to every upstream input.

These wrappers keep the forward result bit-identical (log/exp of NaN is NaN
either way) while routing the backward pass through a select on a safe
finite dummy, so masked NaN levels contribute exactly zero gradient.
Pinned by tests/test_gradients.py (NaN-padded parcel-variant columns).
"""

import jax.numpy as jnp


def notnan(x):
    """``~jnp.isnan(x)`` in ONE primitive.

    ``~jnp.isnan(x)`` traces as ``not(ne(x, x))`` — two vector ops —
    while ``x == x`` is the same predicate (IEEE: NaN is the only value
    not equal to itself; ±inf compare equal) in a single ``eq``.
    """
    x = jnp.asarray(x)
    return x == x


def safe_log(x):
    """``jnp.log(x)`` with a NaN-clean backward pass."""
    x = jnp.asarray(x)
    bad = jnp.isnan(x)
    return jnp.where(bad, jnp.nan, jnp.log(jnp.where(bad, 1.0, x)))


def safe_exp(x):
    """``jnp.exp(x)`` with a NaN-clean backward pass."""
    x = jnp.asarray(x)
    bad = jnp.isnan(x)
    return jnp.where(bad, jnp.nan, jnp.exp(jnp.where(bad, 0.0, x)))
