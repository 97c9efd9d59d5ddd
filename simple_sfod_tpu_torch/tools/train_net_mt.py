"""The adaptation CLI of the port (the port of the JAX package's
`tools/train_net_mt.py`): `train_net` whose --eval-only runs AdaBN (reset
the BatchNorm statistics, recompute them on the train set, evaluate, save
`adabn.pth`).

    python -m simple_sfod_tpu_torch.tools.train_net_mt --config-file configs/X.yaml [...]
"""

from __future__ import annotations

from .train_net import default_argument_parser, main

if __name__ == "__main__":
    main(default_argument_parser().parse_args(), eval_mode="adabn")
