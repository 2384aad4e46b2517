"""reference python/flexflow/keras/utils/ (np_utils.py to_categorical /
normalize, generic_utils.py Progbar + custom-object registry +
serialization helpers, data_utils.py get_file/validate_file/Sequence/
enqueuers, io-utils HDF5Matrix, pad_sequences).

Both import styles work: ``from flexflow.keras.utils import to_categorical``
and ``from flexflow.keras.utils.np_utils import to_categorical``.
"""

import sys as _sys
import types as _types

from ...frontends.keras_utils import (
    CustomObjectScope, GeneratorEnqueuer, HDF5Matrix, OrderedEnqueuer,
    Progbar, Sequence, SequenceEnqueuer, check_for_unexpected_keys,
    custom_object_scope, deserialize_keras_object, func_dump, func_load,
    get_custom_objects, get_file, getargspec, has_arg, is_all_none,
    normalize, object_list_uid, pad_sequences, serialize_keras_object,
    slice_arrays, to_categorical, to_list, transpose_shape,
    unpack_singleton, validate_file)

np_utils = _types.ModuleType(__name__ + ".np_utils")
np_utils.to_categorical = to_categorical
np_utils.normalize = normalize
data_utils = _types.ModuleType(__name__ + ".data_utils")
data_utils.Sequence = Sequence
data_utils.get_file = get_file
data_utils.validate_file = validate_file
data_utils.SequenceEnqueuer = SequenceEnqueuer
data_utils.OrderedEnqueuer = OrderedEnqueuer
data_utils.GeneratorEnqueuer = GeneratorEnqueuer
io_utils = _types.ModuleType(__name__ + ".io_utils")
io_utils.HDF5Matrix = HDF5Matrix
generic_utils = _types.ModuleType(__name__ + ".generic_utils")
for _n in ("Progbar", "CustomObjectScope", "custom_object_scope",
           "get_custom_objects", "serialize_keras_object",
           "deserialize_keras_object", "func_dump", "func_load",
           "getargspec", "has_arg", "to_list", "unpack_singleton",
           "object_list_uid", "is_all_none", "slice_arrays",
           "transpose_shape", "check_for_unexpected_keys"):
    setattr(generic_utils, _n, globals()[_n])
for _m in (np_utils, data_utils, generic_utils, io_utils):
    _sys.modules[_m.__name__] = _m

__all__ = ["to_categorical", "normalize", "pad_sequences", "Sequence",
           "Progbar", "get_file", "validate_file", "np_utils", "data_utils",
           "generic_utils", "io_utils", "HDF5Matrix", "CustomObjectScope",
           "custom_object_scope", "get_custom_objects",
           "serialize_keras_object", "deserialize_keras_object",
           "func_dump", "func_load", "getargspec", "has_arg", "to_list",
           "unpack_singleton", "object_list_uid", "is_all_none",
           "slice_arrays", "transpose_shape", "check_for_unexpected_keys",
           "SequenceEnqueuer", "OrderedEnqueuer", "GeneratorEnqueuer"]
