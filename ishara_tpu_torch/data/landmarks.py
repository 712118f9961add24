"""Landmark column specification for the ASLFR dataset.

A copy of the module of the same name in ``ishara_tpu/data/``: the port
imports nothing of the JAX package.

Defines the 92 selected MediaPipe landmarks (40 lip / 21+21 hands / 5+5 pose)
and their column layout in the flat ``[T, 276]`` feature representation.

Behavioral contract mirrors the reference's column selection
(``Test Notebooks/conv-squeezeformer-conformer-test.ipynb`` cell 1): columns are
ordered ``X + Y + Z``, and within each coordinate block the order is
right-hand(21), left-hand(21), pose(10), lip(40).
"""

from __future__ import annotations

import numpy as np

# MediaPipe face-mesh indices for the lips (40 points).
LIP = [
    61, 185, 40, 39, 37, 0, 267, 269, 270, 409,
    291, 146, 91, 181, 84, 17, 314, 405, 321, 375,
    78, 191, 80, 81, 82, 13, 312, 311, 310, 415,
    95, 88, 178, 87, 14, 317, 402, 318, 324, 308,
]
LPOSE = [13, 15, 17, 19, 21]
RPOSE = [14, 16, 18, 20, 22]
POSE = LPOSE + RPOSE

N_HAND = 21
N_LIP = len(LIP)          # 40
N_POSE = len(POSE)        # 10
N_LANDMARKS = 2 * N_HAND + N_POSE + N_LIP  # 92
N_COLS = 3 * N_LANDMARKS  # 276


def _coord_cols(coord: str) -> list[str]:
    return (
        [f"{coord}_right_hand_{i}" for i in range(N_HAND)]
        + [f"{coord}_left_hand_{i}" for i in range(N_HAND)]
        + [f"{coord}_pose_{i}" for i in POSE]
        + [f"{coord}_face_{i}" for i in LIP]
    )


X_COLS = _coord_cols("x")
Y_COLS = _coord_cols("y")
Z_COLS = _coord_cols("z")
SEL_COLS = X_COLS + Y_COLS + Z_COLS
assert len(SEL_COLS) == N_COLS


def _group_idx(group: str, coord: str) -> np.ndarray:
    """Column indices of a landmark group for one coordinate in SEL_COLS."""
    if group == "lip":
        match = lambda c: "face" in c
    elif group == "rhand":
        match = lambda c: "right" in c
    elif group == "lhand":
        match = lambda c: "left" in c
    elif group == "rpose":
        match = lambda c: "pose" in c and int(c[-2:]) in RPOSE
    elif group == "lpose":
        match = lambda c: "pose" in c and int(c[-2:]) in LPOSE
    else:
        raise ValueError(group)
    return np.array(
        [i for i, c in enumerate(SEL_COLS) if c.startswith(coord + "_") and match(c)],
        dtype=np.int32,
    )


# Per-group, per-coordinate gather indices into the 276-wide raw frame. Stacking
# the x/y/z rows gives one [3, n] index array per group, so a single jnp.take
# produces the [T, n, 3] group tensor (reference: pre_process0, nb cell 3).
GROUPS = ("lip", "rhand", "lhand", "rpose", "lpose")
GROUP_SIZES = {"lip": N_LIP, "rhand": N_HAND, "lhand": N_HAND, "rpose": 5, "lpose": 5}
GROUP_IDX = {
    g: np.stack([_group_idx(g, c) for c in ("x", "y", "z")], axis=-1)  # [n, 3]
    for g in GROUPS
}

# Order in which groups are concatenated along the landmark axis when the flat
# [T, 276] model input is rebuilt (reference: pre_process1, nb cell 3).
CONCAT_ORDER = ("lip", "rhand", "lhand", "rpose", "lpose")

# Default sequence geometry (reference nb cell 1).
FRAME_LEN = 128 + 48  # 176
MAX_PHRASE_LENGTH = 64
