"""Parameter audit (the reference's examples/model_stats.ipynb): trainable
and frozen parameter counts and name lists per subsystem, port of the JAX
package's ``examples/model_stats.py``.

    python -m flamingo_mini_tpu_torch.examples.model_stats [--device cpu]
"""
from typing import List, Optional, Tuple

from .. import FlamingoConfig, FlamingoModel
from ..modeling_flamingo import flatten_tree
from . import parse_args


def main(argv: Optional[List[str]] = None) -> Tuple[int, int]:
    args = parse_args(__doc__, argv)
    config = FlamingoConfig(
        lm="gpt2", clip_model_type="openai/clip-vit-base-patch32",
        dim=768, dim_visual=768)
    model = FlamingoModel(config, device=args.device)

    total = model.num_parameters()
    trainable = model.num_parameters(only_trainable=True)
    print(f"total params:     {total:>12,}")
    print(f"trainable params: {trainable:>12,} ({100*trainable/total:.1f}%)")

    mask = model.trainable_mask()
    flat_p = flatten_tree(model.params)
    flat_m = flatten_tree(mask)

    by_group = {}
    for k, v in flat_p.items():
        group = k.split(".")[0]
        t = bool(flat_m[k])
        tot, tr = by_group.get(group, (0, 0))
        by_group[group] = (tot + v.size, tr + (v.size if t else 0))
    print("\nper subsystem:")
    for g, (tot, tr) in sorted(by_group.items()):
        print(f"  {g:<12} {tot:>12,} total {tr:>12,} trainable")

    print("\ntrainable leaves:")
    for k in sorted(k for k, m in flat_m.items() if m):
        print("  ", k, tuple(flat_p[k].shape))
    return total, trainable


if __name__ == "__main__":
    main()
