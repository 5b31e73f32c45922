"""The device a measurement runs on: refuse anything but a GPU, name the card.

A time or a rate is only meaningful beside the card that produced it, and a
card may run below its maximum power limit, so measurement scripts print
both as ``nvidia-smi`` reports them and fail outright when JAX finds no GPU.
"""

import subprocess

import jax

NVIDIA_SMI_QUERY = ('nvidia-smi', '--query-gpu=name,power.limit',
                    '--format=csv,noheader')


def require_gpu():
    """JAX's devices, when the first is a GPU; RuntimeError otherwise."""
    devices = jax.devices()
    if devices[0].platform != 'gpu':
        raise RuntimeError(
            f'no GPU: JAX device 0 is {devices[0].platform} '
            f'({devices[0].device_kind}); this measurement runs only on '
            'an NVIDIA GPU')
    return devices


def parse_nvidia_smi(text):
    """``[(name, power_limit), ...]``, one per card, from the output of
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    (e.g. ``NVIDIA H100 80GB HBM3, 700.00 W``)."""
    cards = []
    for line in text.splitlines():
        if not line.strip():
            continue
        name, sep, limit = line.rpartition(',')
        if not sep or not name.strip() or not limit.strip():
            raise ValueError(f'not a "name, power.limit" line: {line!r}')
        cards.append((name.strip(), limit.strip()))
    return cards


def card_lines():
    """The cards' ``name, power.limit`` lines exactly as nvidia-smi prints
    them (checked by :func:`parse_nvidia_smi`)."""
    text = subprocess.run(NVIDIA_SMI_QUERY, capture_output=True, text=True,
                          check=True, timeout=60).stdout
    if not parse_nvidia_smi(text):
        raise RuntimeError('nvidia-smi listed no card')
    return [line.strip() for line in text.splitlines() if line.strip()]
