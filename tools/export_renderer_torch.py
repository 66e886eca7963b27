#!/usr/bin/env python
"""Export a trained experiment of the PyTorch port as a serving artifact.

Builds the model as training does (the config and the scene's camera and
bounding box), restores the newest checkpoint (or ``--ft_path``), and
traces the eval render with ``torch.export``: the weights held in the
program (the fields' packed tables), the rgb CRF folded in, one file
(``evdeblurnerf_torch/serving.py``). Serving it then needs torch and the
port's kernel ops, no model code, config or checkpoint.

The program renders on the device of ``--device`` (the card unless
``--device cpu``), recorded in the header.

Usage:
  python tools/export_renderer_torch.py --config configs/<exp>.txt \\
      --out scene.evdnpt [--export_chunk 32768]
"""

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main(argv=None):
    # thin wrapper: the packaged CLI (``evdn-export-torch``) holds the logic
    from evdeblurnerf_torch.cli import export_main

    return export_main(argv)


if __name__ == "__main__":
    main()
