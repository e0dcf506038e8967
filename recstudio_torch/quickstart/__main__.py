"""Command line: ``python -m recstudio_torch.quickstart -m BPR -d ml-100k
[--flags]``, the port's counterpart of the root ``run.py``. The flags are
the leaves of the model's merged config (``--epochs 3``, ``--learner
sparse_adam``, ...); ``--device cpu`` runs on the CPU."""
import json

from recstudio_torch.quickstart import run
from recstudio_torch.utils import get_model
from recstudio_torch.utils.arguments import (add_model_arguments, get_default_parser,
                                             parser2nested_dict)


def main(argv=None):
    parser = get_default_parser()
    parser.add_argument("--device", type=str, default="cuda", help="cuda or cpu")
    args, _ = parser.parse_known_args(argv)
    _, default_conf = get_model(args.model)
    parser = add_model_arguments(parser, default_conf)
    args = parser.parse_args(argv)
    overrides = parser2nested_dict(args, ignore=("model", "dataset", "mode", "data_dir",
                                                 "device"))
    _, _, result = run(args.model, args.dataset, model_config=overrides or None,
                       run_mode=args.mode, device=args.device)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
