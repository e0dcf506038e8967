from .arguments import add_model_arguments, get_default_parser, parser2nested_dict
from .config import deep_update, get_base_model_config, load_json
from .device import resolve_device
from .registry import get_dataset_default_config, get_model, list_models
from .seed import make_generator, seed_everything

__all__ = ["add_model_arguments", "get_default_parser", "parser2nested_dict", "deep_update", "get_base_model_config", "load_json", "resolve_device",
           "get_dataset_default_config", "get_model", "list_models",
           "make_generator", "seed_everything"]
