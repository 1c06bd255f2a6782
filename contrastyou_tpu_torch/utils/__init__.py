from .general import class_name, flatten_dict, ignore_exception, ntuple, path2Path, safe_save
from .rng import fix_all_seed
from .tensor import (class2one_hot, logits2class, one_hot, probs2class, probs2one_hot,
                     simplex)

__all__ = ["class_name", "flatten_dict", "ignore_exception", "ntuple", "path2Path",
           "safe_save", "fix_all_seed", "class2one_hot", "logits2class", "one_hot",
           "probs2class", "probs2one_hot", "simplex"]
