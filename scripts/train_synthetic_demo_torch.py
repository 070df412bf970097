"""Train the demo-width DeepPointMap on a synthetic world with the
PyTorch/CUDA port, then run the whole SLAM system with the trained weights
around a closed loop (the port's counterpart of
scripts/train_synthetic_demo.py; the recipe lives in
deeppointmap_tpu_torch/pipeline/demo.py).

Usage: python scripts/train_synthetic_demo_torch.py [--steps 400]
           [--loop_steps 150] [--frames 60] [--device cpu]

The world goes to --root and the weights (weights_final.msgpack, which the
JAX package's load_weights reads too), training logs and trajectories to
--out, both under the ignored log_infer/ by default.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from deeppointmap_tpu_torch.pipeline.demo import main  # noqa: E402

if __name__ == "__main__":
    main()
