"""Trajectory evaluation CLI of the PyTorch/CUDA port (the counterpart of
scripts/evaluate.py; the code lives in
deeppointmap_tpu_torch/pipeline/evaluate.py, which also runs as
`python -m deeppointmap_tpu_torch.pipeline.evaluate`).

Usage: python scripts/evaluate_torch.py PRED.txt GT.txt [--delta 1]
           [--no-align] [--json]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from deeppointmap_tpu_torch.pipeline.evaluate import main  # noqa: E402

if __name__ == "__main__":
    main()
