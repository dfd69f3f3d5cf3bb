"""The port's own copy of the few flags its serving and training slices read.

The JAX package keeps ~70 flags in ``paddle_tpu/flags.py``; importing it
would import JAX, so the port carries only what its main path consults,
under the same names, with the JAX defaults, and the same ``FLAGS_``
spelling at the public ``get_flags``/``set_flags`` surface. A flag takes
only the values the port implements: setting another is refused, not
silently ignored.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable

__all__ = ["flag", "get_flags", "set_flags"]

# name -> (the values the port implements, the first being the default;
#          why no other is)
_FLAGS: Dict[str, tuple] = {
    # the JAX default: the engine's paged step runs the fused decode layer
    # loop (kernels A, B, C); False runs the layer modules (kernel 4, RMSNorm
    # kernel 7), as in JAX
    "use_fused_decode_layer": ((True, False), "it is a bool"),
    # the JAX default is True
    "enable_prefix_cache": ((False,), "the prefix cache is not ported yet"),
    # 'bf16' means the unquantized pool in the model's dtype (the JAX
    # meaning); 'int8' the pool of int8 K/V rows with fp32 per-token scales
    "kv_cache_dtype": (("bf16", "int8"), "it is 'bf16' or 'int8'"),
    # the JAX default: the engine quantizes the MLP projections and the lm
    # head to int8 with per-output-channel scales when True (kernel 20)
    "weight_only_int8": ((False, True), "it is a bool"),
    # attention runs the flash kernels (14-16); the JAX XLA fallback is a
    # test-only reference here, never a silent path on the card
    "use_pallas_attention": ((True,), "attention always runs the flash-attention kernels"),
    # the JAX default: RMSNorm and rope run kernels 7-10 wherever a shape is
    # within their reach
    "use_pallas_fused": ((True,), "the RMSNorm and rope kernels (7-10) run wherever a shape is within "
                                  "their reach; the unfused-order composition runs only for shapes outside "
                                  "it, as in JAX, and is not a switch of its own yet"),
    # the JAX default: the loss head runs the fused linear cross entropy
    # (kernels 17-19); False materialises the logits, as in JAX
    "use_fused_loss": ((True, False), "it is a bool"),
}
_values: Dict[str, Any] = {name: allowed[0] for name, (allowed, _) in _FLAGS.items()}


def _key(name: str) -> str:
    key = name[len("FLAGS_"):] if name.startswith("FLAGS_") else name
    if key not in _FLAGS:
        raise KeyError(f"unknown flag {name!r}; known: {sorted(_FLAGS)}")
    return key


def flag(name: str) -> Any:
    """The value of one flag."""
    return _values[_key(name)]


def get_flags(names: Iterable[str]) -> Dict[str, Any]:
    """``{"FLAGS_x": value}`` for each requested name (Paddle's surface)."""
    if isinstance(names, str):
        names = [names]
    return {f"FLAGS_{_key(n)}": flag(n) for n in names}


def set_flags(values: Dict[str, Any]) -> None:
    """Set flags by name; raises on unknown names and unsupported values
    (and then sets none of them). A value must be of the flag's own type:
    the string ``"False"`` is not a bool, and is refused rather than read
    as ``bool("False")``."""
    new = {}
    for name, value in values.items():
        key = _key(name)
        allowed, why = _FLAGS[key]
        match = [a for a in allowed if type(value) is type(a) and value == a]
        if not match:
            raise ValueError(f"{name}={value!r} is not supported by paddle_tpu_torch: {why}")
        new[key] = match[0]
    _values.update(new)
