"""Built-in edit-sweep distance presets (the port's copy of
``transeditor_tpu/edit/presets.py``).

The reference ships per-attribute sweep configs as JSON files under
``our_interfaceGAN/config_noinversion/*.json`` and
``config_inversion/*.json`` and resolves them by attribute name (FFHQ
DEX attributes) or by ``--attribute_index`` (CelebA-HQ; the numbered
files, resolution logic at ``edit_all_noinversion_celebahq.py:128-141``).
The seed grid lives in a separate ``seed.json`` (``:232-236``) that is
combined with the distance config.

Here the same tables are shipped as data so ``cli.edit --config preset``
works without the reference tree; an explicit ``--config path.json``
(including the reference's own files) still takes precedence.
"""

from __future__ import annotations

from typing import Optional

# seed.json in both config dirs: range(0, 100)
SEED_RANGE = [0, 100]

# config_noinversion/*.json — keyed by FFHQ attribute name or CelebA-HQ
# attribute index (see CELEBAHQ_ATTRIBUTES for the index order).
NOINVERSION = {
    "age": {"style_end_distance": [2.5], "content_end_distance": [1]},
    "gender": {"style_end_distance": [3.5], "content_end_distance": [1]},
    "pose": {"style_end_distance": [1], "content_end_distance": [17]},
    0: {"style_end_distance": [5], "content_end_distance": [3]},
    1: {"style_end_distance": [30], "content_end_distance": [5]},
    3: {"style_end_distance": [0.5], "content_end_distance": [6.5]},
    8: {"style_end_distance": [1], "content_end_distance": [8]},
    9: {"style_end_distance": [0.5], "content_end_distance": [4]},
    12: {"style_end_distance": [110], "content_end_distance": [5]},
    13: {"style_end_distance": [110], "content_end_distance": [5]},
}

# config_inversion/*.json — distances for encoder-inverted real-image
# latents are much larger (plus-space codes are farther from the origin).
INVERSION = {
    "age": {"style_end_distance": [2], "content_end_distance": [30]},
    "gender": {"style_end_distance": [40], "content_end_distance": [7]},
    "pose": {"style_end_distance": [1], "content_end_distance": [20]},
    0: {"style_end_distance": [300], "content_end_distance": [7]},
    1: {"style_end_distance": [110], "content_end_distance": [5]},
    3: {"style_end_distance": [10], "content_end_distance": [15]},
    4: {"style_end_distance": [20], "content_end_distance": [8]},
    8: {"style_end_distance": [20], "content_end_distance": [8]},
    9: {"style_end_distance": [30], "content_end_distance": [8]},
    12: {"style_end_distance": [70], "content_end_distance": [5]},
    13: {"style_end_distance": [70], "content_end_distance": [5]},
}


def sweep_preset(attribute: str,
                 attribute_index: Optional[int] = None,
                 inversion: bool = False,
                 with_seeds: bool = False) -> Optional[dict]:
    """Resolve the reference's sweep config for an attribute.

    Mirrors ``edit_all_*_{ffhq,celebahq}.py``: FFHQ attributes resolve
    by name, CelebA-HQ by index; returns None when the reference ships
    no config for that attribute. ``with_seeds`` additionally merges
    the seed grid like the reference's two-file combination.
    """
    table = INVERSION if inversion else NOINVERSION
    cfg = table.get(attribute)
    if cfg is None and attribute_index is not None:
        cfg = table.get(attribute_index)
    if cfg is None:
        return None
    cfg = dict(cfg)
    if with_seeds:
        cfg["seed"] = list(SEED_RANGE)
    return cfg
