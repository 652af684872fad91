"""Saving and loading results: pickle (optionally gzipped) and HDF5.

Port of ``tenpy_tpu/tools/io.py``, in the HDF5 format of the reference
library (``doc/intro/input_output.rst`` of TeNPy): the type of every node
in its ``'type'`` attribute with the same ``REPR_*`` vocabulary,
``simple_dict``/``dict`` layouts, lists, tuples and sets as groups of
children ``'0', '1', ...`` with a ``'len'`` attribute, hard links for
shared (and cyclic) objects, and ``'instance'`` groups with ``'class'`` and
``'module'`` attributes for the objects that define
``save_hdf5``/``from_hdf5``.

Interchange: the port's charge, tensor, site, MPS and MPO classes are
saved under the reference module paths (:data:`COMPAT_MODULES`), so the
JAX package and the reference library load the port's files; on loading,
a module of the reference library (``tenpy.``) or of the JAX package
(``tenpy_tpu.``) resolves to its counterpart in this package
(:func:`find_global`), never to the literal path, so an HDF5 file written
by either loads into the port's objects with no JAX imported.  Pickles are
read by :func:`load_pickle`, which refuses the classes of the JAX package,
of the reference library and of JAX itself (their objects carry their own
attribute layouts and JAX arrays) before anything is imported: such
results load into the port when saved as ``.h5``.

Tensors: the port's :class:`~tenpy_tpu_torch.linalg.np_conserved.Array`
writes its blocks as numpy arrays and reads them back as CPU torch
tensors; any other torch tensor met on the way is written from the host as
a numpy array (and so read back as one), and a pickle never carries a
CUDA tensor (a file must load on a machine without
a card).  ``h5py`` is imported only when an HDF5 file is read or written.
"""

from __future__ import annotations

import gzip
import importlib
import pickle
import warnings

import numpy as np
import torch

from .misc import port_module_name

__all__ = ['save', 'load', 'save_pickle', 'load_pickle', 'to_host',
           'save_to_hdf5', 'load_from_hdf5', 'Hdf5Exportable', 'Hdf5Saver',
           'Hdf5Loader', 'Hdf5FormatError', 'Hdf5ExportError', 'Hdf5ImportError',
           'valid_hdf5_path_component', 'find_global', 'compat_module',
           'COMPAT_MODULES', 'ATTR_TYPE', 'ATTR_CLASS', 'ATTR_MODULE',
           'ATTR_LEN', 'ATTR_FORMAT', 'REPR_HDF5EXPORTABLE']

# the REPR_* / ATTR_* vocabulary of the reference HDF5 format
REPR_HDF5EXPORTABLE = 'instance'
REPR_REDUCE = 'reduce'
REPR_ARRAY = 'array'
REPR_MASKED_ARRAY = 'masked_array'
REPR_INT = 'int'
REPR_INT_AS_STR = 'int_as_str'
REPR_FLOAT = 'float'
REPR_STR = 'str'
REPR_BYTES = 'bytes'
REPR_COMPLEX = 'complex'
REPR_INT64 = 'np.int64'
REPR_FLOAT64 = 'np.float64'
REPR_COMPLEX128 = 'np.complex128'
REPR_INT32 = 'np.int32'
REPR_FLOAT32 = 'np.float32'
REPR_COMPLEX64 = 'np.complex64'
REPR_BOOL = 'bool'
REPR_NONE = 'None'
REPR_RANGE = 'range'
REPR_LIST = 'list'
REPR_TUPLE = 'tuple'
REPR_SET = 'set'
REPR_DICT_GENERAL = 'dict'
REPR_DICT_SIMPLE = 'simple_dict'
REPR_DTYPE = 'dtype'
REPR_FUNCTION = 'function'
REPR_CLASS = 'class'
REPR_GLOBAL = 'global'
REPR_IGNORED = 'ignore'

ATTR_TYPE = 'type'
ATTR_CLASS = 'class'
ATTR_MODULE = 'module'
ATTR_LEN = 'len'
ATTR_FORMAT = 'format'

_SCALAR_REPRS = {
    bool: REPR_BOOL,
    int: REPR_INT,
    float: REPR_FLOAT,
    complex: REPR_COMPLEX,
    np.int64: REPR_INT64,
    np.float64: REPR_FLOAT64,
    np.complex128: REPR_COMPLEX128,
    np.int32: REPR_INT32,
    np.float32: REPR_FLOAT32,
    np.complex64: REPR_COMPLEX64,
    np.bool_: REPR_BOOL,
}
_SCALAR_LOADERS = {
    REPR_BOOL: bool,
    REPR_INT: int,
    REPR_FLOAT: float,
    REPR_COMPLEX: complex,
    REPR_INT64: np.int64,
    REPR_FLOAT64: np.float64,
    REPR_COMPLEX128: np.complex128,
    REPR_INT32: np.int32,
    REPR_FLOAT32: np.float32,
    REPR_COMPLEX64: np.complex64,
}


class Hdf5FormatError(Exception):
    """Base class for errors of the HDF5 format."""


class Hdf5ExportError(Hdf5FormatError):
    pass


class Hdf5ImportError(Hdf5FormatError):
    pass


def valid_hdf5_path_component(name):
    """Whether ``name`` can be a child's name: a string without ``'/'``
    that is not ``'.'``."""
    return isinstance(name, str) and '/' not in name and name != '.'


# Modules whose HDF5 layout is the reference library's: their objects are
# saved under the reference module path, so the reference library and the
# JAX package load the port's files.
COMPAT_MODULES = {
    'tenpy_tpu_torch.linalg.np_conserved': 'tenpy.linalg.np_conserved',
    'tenpy_tpu_torch.linalg.charges': 'tenpy.linalg.charges',
    'tenpy_tpu_torch.linalg.truncation': 'tenpy.linalg.truncation',
    'tenpy_tpu_torch.networks.site': 'tenpy.networks.site',
    'tenpy_tpu_torch.networks.mps': 'tenpy.networks.mps',
    'tenpy_tpu_torch.networks.mpo': 'tenpy.networks.mpo',
}


def compat_module(module):
    """The module path an object of ``module`` is saved under."""
    return COMPAT_MODULES.get(module, module)


def find_global(module, qualified_name):
    """The global ``module.qualified_name`` (dotted), with ``tenpy.`` and
    ``tenpy_tpu.`` modules resolved in this package; raises
    :class:`Hdf5ImportError` where it does not exist."""
    mod_name = port_module_name(module)
    try:
        obj = importlib.import_module(mod_name)
        for part in qualified_name.split('.'):
            obj = getattr(obj, part)
    except (ImportError, AttributeError) as e:
        raise Hdf5ImportError(f"can't resolve {module}.{qualified_name} "
                              f"(as {mod_name}): {e}") from e
    return obj


def to_host(obj):
    """A torch tensor as a host numpy array; anything else unchanged."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().resolve_conj().numpy()
    return obj


class _HostPickler(pickle.Pickler):
    """Pickles CUDA tensors as their host copies (a CUDA tensor does not
    load where there is no card)."""

    def reducer_override(self, obj):
        if isinstance(obj, torch.Tensor) and obj.device.type != 'cpu':
            return obj.detach().cpu().__reduce_ex__(pickle.HIGHEST_PROTOCOL)
        return NotImplemented


def save_pickle(data, f):
    """Pickle ``data`` into the open binary file ``f``, CUDA tensors moved
    to the host."""
    _HostPickler(f, protocol=pickle.HIGHEST_PROTOCOL).dump(data)


# packages whose pickled objects do not load into the port: the JAX
# package and the reference library pickle their own attribute layouts
# (and the JAX package JAX arrays), and importing either imports JAX
_FOREIGN_PACKAGES = ('tenpy', 'tenpy_tpu', 'jax', 'jaxlib')


class _PortUnpickler(pickle.Unpickler):
    """Refuses a global of :data:`_FOREIGN_PACKAGES` before importing
    anything."""

    def find_class(self, module, name):
        if module.split('.')[0] in _FOREIGN_PACKAGES:
            raise Hdf5ImportError(
                f"the pickle holds {module}.{name}: a pickle written by "
                f"tenpy_tpu or TeNPy does not load into tenpy_tpu_torch "
                f"(other object layouts, JAX arrays); save it as .h5, "
                f"which does")
        return super().find_class(module, name)


def load_pickle(f):
    """Unpickle from the open binary file ``f``; raises
    :class:`Hdf5ImportError` where the pickle names a class or function of
    the JAX package, the reference library or JAX."""
    return _PortUnpickler(f).load()


def _h5py():
    import h5py
    return h5py


# ---------------------------------------------------------- file-level API
def save(data, filename, mode='w'):
    """Save ``data``; the format by the extension: ``.pkl``/``.pickle``,
    ``.pkl.gz``/``.pklz``, ``.h5``/``.hdf5``."""
    filename = str(filename)
    if filename.endswith(('.pkl', '.pickle')):
        with open(filename, mode + 'b') as f:
            save_pickle(data, f)
    elif filename.endswith(('.pkl.gz', '.pklz')):
        with gzip.open(filename, mode + 'b') as f:
            save_pickle(data, f)
    elif filename.endswith(('.h5', '.hdf5')):
        with _h5py().File(filename, mode) as f:
            save_to_hdf5(f, data)
    else:
        raise ValueError(f"unsupported filename extension: {filename}")


def load(filename):
    """Load what :func:`save` wrote (or the JAX package or the reference
    library wrote in these formats)."""
    filename = str(filename)
    if filename.endswith(('.pkl', '.pickle')):
        with open(filename, 'rb') as f:
            return load_pickle(f)
    if filename.endswith(('.pkl.gz', '.pklz')):
        with gzip.open(filename, 'rb') as f:
            return load_pickle(f)
    if filename.endswith(('.h5', '.hdf5')):
        with _h5py().File(filename, 'r') as f:
            return load_from_hdf5(f)
    raise ValueError(f"unsupported filename extension: {filename}")


class Hdf5Exportable:
    """Mixin: save and load ``self.__dict__`` in the dict layouts (which
    one goes to the ``'format'`` attribute)."""

    def save_hdf5(self, hdf5_saver, h5gr, subpath):
        type_repr = hdf5_saver.save_dict_content(self.__dict__, h5gr,
                                                 subpath)
        h5gr.attrs[ATTR_FORMAT] = type_repr

    @classmethod
    def from_hdf5(cls, hdf5_loader, h5gr, subpath):
        dict_format = hdf5_loader.get_attr(h5gr, ATTR_FORMAT)
        obj = cls.__new__(cls)
        hdf5_loader.memorize_load(h5gr, obj)
        obj.__dict__.update(hdf5_loader.load_dict(h5gr, dict_format,
                                                  subpath))
        return obj


# ------------------------------------------------------------------ saving
class Hdf5Saver:
    """Save nested python objects into an HDF5 group.

    Shared and cyclic objects are saved once and hard-linked where they
    appear again; the memo keeps ``(group, obj)`` so that temporaries stay
    alive (their ``id`` is not reused) for the whole save."""

    def __init__(self, h5group):
        self.h5group = h5group
        self.memo_save = {}

    def save(self, obj, path='/'):
        """Save ``obj`` at ``path``; returns the group or dataset."""
        in_memo = self.memo_save.get(id(obj))
        if in_memo is not None:
            h5gr, _ = in_memo
            self.h5group[path.rstrip('/') or '/'] = h5gr  # hard link
            return h5gr
        host = to_host(obj)
        if host is not obj:
            res = self._dispatch(host, path.rstrip('/'))
            self.memo_save[id(obj)] = (res, obj)
            return res
        return self._dispatch(obj, path.rstrip('/'))

    def create_group_for_obj(self, path, obj):
        """A new group at ``path`` (the root for '' or '/'), memoized for
        ``obj``; returns ``(group, subpath)``."""
        h5gr = self._group(path)
        self.memo_save[id(obj)] = (h5gr, obj)
        return h5gr, (path.rstrip('/') + '/')

    def _group(self, path):
        if path in ('', '/'):
            return self.h5group['/']
        return self.h5group.create_group(path)

    def memorize_save(self, h5gr, obj):
        self.memo_save[id(obj)] = (h5gr, obj)

    def _dataset(self, p, value, type_repr, obj):
        f = self.h5group
        f[p] = value
        f[p].attrs[ATTR_TYPE] = type_repr
        self.memorize_save(f[p], obj)
        return f[p]

    def _dispatch(self, obj, p):
        if obj is None:
            g = self._group(p)
            g.attrs[ATTR_TYPE] = REPR_NONE
            return g
        t = type(obj)
        repr_scalar = _SCALAR_REPRS.get(t)
        if repr_scalar is not None:
            if repr_scalar == REPR_INT and not -2 ** 63 <= obj < 2 ** 63:
                return self._dataset(p, str(obj), REPR_INT_AS_STR, obj)
            return self._dataset(p, obj, repr_scalar, obj)
        if t is str:
            return self._dataset(p, obj, REPR_STR, obj)
        if t is bytes:
            return self._dataset(p, np.void(obj), REPR_BYTES, obj)
        if t is range:
            g, sub = self.create_group_for_obj(p, obj)
            g.attrs[ATTR_TYPE] = REPR_RANGE
            self.save(obj.start, sub + 'start')
            self.save(obj.stop, sub + 'stop')
            self.save(obj.step, sub + 'step')
            return g
        if isinstance(obj, np.dtype):
            g, sub = self.create_group_for_obj(p, obj)
            g.attrs[ATTR_TYPE] = REPR_DTYPE
            # the reference layout: attribute 'name' for simple dtypes,
            # child 'descr' for structured ones
            g.attrs['name'] = getattr(obj, 'name', 'void')
            self.save(obj.descr, sub + 'descr')
            return g
        if isinstance(obj, np.ma.MaskedArray):
            g, sub = self.create_group_for_obj(p, obj)
            g.attrs[ATTR_TYPE] = REPR_MASKED_ARRAY
            self.save(np.asarray(obj.data), sub + 'data')
            self.save(np.asarray(obj.mask), sub + 'mask')
            return g
        if isinstance(obj, np.ndarray):
            if obj.dtype == object:
                raise Hdf5ExportError("cannot save object-dtype arrays")
            return self._dataset(p, obj, REPR_ARRAY, obj)
        if isinstance(obj, np.generic):
            return self._dataset(p, np.asarray(obj), REPR_ARRAY, obj)
        if t in (list, tuple, set):
            type_repr = {list: REPR_LIST, tuple: REPR_TUPLE,
                         set: REPR_SET}[t]
            return self.save_iterable(obj, p, type_repr)
        if t is dict:
            return self.save_dict(obj, p)
        if hasattr(obj, 'save_hdf5'):
            if isinstance(obj, type):
                return self._save_global(obj, p)
            g, sub = self.create_group_for_obj(p, obj)
            g.attrs[ATTR_TYPE] = REPR_HDF5EXPORTABLE
            g.attrs[ATTR_CLASS] = obj.__class__.__qualname__
            g.attrs[ATTR_MODULE] = compat_module(obj.__class__.__module__)
            obj.save_hdf5(self, g, sub)
            return g
        if isinstance(obj, type) or callable(obj):
            g = self._save_global(obj, p)
            if g is not None:
                return g
        return self._save_reduce(obj, p)

    def _save_global(self, obj, p):
        """A class or function by its module and name (None where that
        does not resolve to ``obj``)."""
        mod = getattr(obj, '__module__', None)
        qualname = getattr(obj, '__qualname__', None)
        if mod is None or qualname is None:
            return None
        try:
            if find_global(mod, qualname) is not obj:
                return None
        except Hdf5ImportError:
            return None
        g = self._group(p)
        g.attrs[ATTR_TYPE] = REPR_CLASS if isinstance(obj, type) \
            else REPR_FUNCTION
        g.attrs[ATTR_CLASS] = qualname
        g.attrs[ATTR_MODULE] = compat_module(mod)
        self.memorize_save(g, obj)
        return g

    def save_iterable(self, obj, path, type_repr):
        g, sub = self.create_group_for_obj(path, obj)
        g.attrs[ATTR_TYPE] = type_repr
        g.attrs[ATTR_LEN] = len(obj)
        for i, v in enumerate(obj):
            self.save(v, sub + str(i))
        return g

    def save_dict(self, obj, path):
        g, sub = self.create_group_for_obj(path, obj)
        g.attrs[ATTR_TYPE] = self.save_dict_content(obj, g, sub)
        return g

    def save_dict_content(self, obj, h5gr, subpath):
        """The entries of a dict into the existing group ``h5gr``: keys
        that are valid names as children (``simple_dict``), else lists
        ``keys`` and ``values`` (``dict``).  Returns the layout's REPR."""
        if all(valid_hdf5_path_component(k) for k in obj.keys()):
            for k, v in obj.items():
                self.save(v, subpath + k)
            return REPR_DICT_SIMPLE
        self.save_iterable(list(obj.keys()), subpath + 'keys', REPR_LIST)
        self.save_iterable(list(obj.values()), subpath + 'values',
                           REPR_LIST)
        return REPR_DICT_GENERAL

    def _save_reduce(self, obj, path):
        """By the pickle ``__reduce__`` protocol, or as raw pickle bytes
        where the object does not reduce to a global and arguments."""
        try:
            red = obj.__reduce__()
        except Exception:  # noqa: BLE001 - saved as raw pickle below
            red = None
        if red is not None and not isinstance(red, str) and \
                2 <= len(red) <= 3:
            func, args = red[0], red[1]
            state = red[2] if len(red) > 2 else None
            if getattr(func, '__module__', None) is not None and \
                    getattr(func, '__qualname__', None) is not None:
                g, sub = self.create_group_for_obj(path, obj)
                g.attrs[ATTR_TYPE] = REPR_REDUCE
                self.save(func, sub + 'func')
                self.save(list(args), sub + 'args')
                if state is not None:
                    self.save(state, sub + 'state')
                return g
        warnings.warn(f"hdf5: saving {type(obj).__name__} as raw pickle "
                      f"bytes", stacklevel=3)
        import io as _io
        buf = _io.BytesIO()
        save_pickle(obj, buf)
        return self._dataset(path, np.frombuffer(buf.getvalue(), np.uint8),
                             'pickle', obj)


# ----------------------------------------------------------------- loading
class Hdf5Loader:
    """Load objects saved by :class:`Hdf5Saver` (or by the JAX package or
    the reference library)."""

    def __init__(self, h5group):
        self.h5group = h5group
        self.memo_load = {}

    def memorize_load(self, h5gr, obj):
        self.memo_load[h5gr.id] = obj

    def get_attr(self, h5gr, name):
        if name not in h5gr.attrs:
            raise Hdf5ImportError(
                f"missing attribute {name!r} for {h5gr.name!r}")
        v = h5gr.attrs[name]
        return v.decode() if isinstance(v, bytes) else v

    def load(self, path='/'):
        node = self.h5group[path.rstrip('/') or '/']
        if node.id in self.memo_load:
            return self.memo_load[node.id]
        t = node.attrs.get(ATTR_TYPE, None)
        if isinstance(t, bytes):
            t = t.decode()
        if t is None:
            raise Hdf5ImportError(f"no {ATTR_TYPE!r} attribute at "
                                  f"{node.name}")
        if t in (REPR_NONE, REPR_IGNORED):
            return None
        if t in _SCALAR_LOADERS:
            return _SCALAR_LOADERS[t](node[()])
        if t in (REPR_INT_AS_STR, REPR_STR):
            v = node[()]
            v = v.decode() if isinstance(v, bytes) else str(v)
            return int(v) if t == REPR_INT_AS_STR else v
        if t == REPR_BYTES:
            return bytes(node[()])
        if t == REPR_ARRAY:
            obj = np.asarray(node[()])
        elif t == REPR_MASKED_ARRAY:
            obj = np.ma.MaskedArray(self.load(node.name + '/data'),
                                    mask=self.load(node.name + '/mask'))
        elif t == REPR_DTYPE:
            obj = self._load_dtype(node)
        elif t == REPR_RANGE:
            return range(self.load(node.name + '/start'),
                         self.load(node.name + '/stop'),
                         self.load(node.name + '/step'))
        elif t in (REPR_LIST, REPR_TUPLE, REPR_SET):
            return self.load_list(node, t)
        elif t in (REPR_DICT_SIMPLE, REPR_DICT_GENERAL):
            obj = {}
            self.memorize_load(node, obj)
            obj.update(self.load_dict(node, t, node.name + '/'))
            return obj
        elif t in (REPR_CLASS, REPR_FUNCTION, REPR_GLOBAL):
            obj = find_global(self.get_attr(node, ATTR_MODULE),
                              self.get_attr(node, ATTR_CLASS))
        elif t == REPR_HDF5EXPORTABLE:
            cls = find_global(self.get_attr(node, ATTR_MODULE),
                              self.get_attr(node, ATTR_CLASS))
            return cls.from_hdf5(self, node, node.name + '/')
        elif t == REPR_REDUCE:
            func = self.load(node.name + '/func')
            obj = func(*self.load(node.name + '/args'))
            self.memorize_load(node, obj)
            if 'state' in node:
                state = self.load(node.name + '/state')
                if hasattr(obj, '__setstate__'):
                    obj.__setstate__(state)
                elif isinstance(state, dict):
                    obj.__dict__.update(state)
            return obj
        elif t == 'pickle':
            import io as _io
            obj = load_pickle(_io.BytesIO(bytes(node[()])))
        else:
            raise Hdf5ImportError(f"unknown hdf5 node type {t!r} at "
                                  f"{node.name}")
        self.memorize_load(node, obj)
        return obj

    def _load_dtype(self, node):
        name = node.attrs.get('name')
        if isinstance(name, bytes):
            name = name.decode()
        if name is not None and not str(name).startswith('void'):
            return np.dtype(name)
        descr = self.load(node.name + '/descr')
        if isinstance(descr, str):
            return np.lib.format.descr_to_dtype(descr)
        return np.dtype([tuple(fld) for fld in descr])

    def load_list(self, node, type_repr):
        n = int(self.get_attr(node, ATTR_LEN))
        res = []
        if type_repr == REPR_LIST:
            self.memorize_load(node, res)  # cycles through lists
        items = [self.load(f"{node.name}/{i}") for i in range(n)]
        res.extend(items)
        if type_repr == REPR_TUPLE:
            res = tuple(items)
            self.memorize_load(node, res)
        elif type_repr == REPR_SET:
            res = set(items)
            self.memorize_load(node, res)
        return res

    def load_dict(self, h5gr, type_repr, subpath):
        """The content of a dict group in either layout."""
        if type_repr == REPR_DICT_SIMPLE:
            return {k: self.load(subpath + k) for k in h5gr.keys()}
        if type_repr == REPR_DICT_GENERAL:
            return dict(zip(self.load(subpath + 'keys'),
                            self.load(subpath + 'values')))
        raise Hdf5ImportError(f"unknown dict format {type_repr!r}")


def save_to_hdf5(h5group, obj, path='/'):
    """Save ``obj`` into an open h5py group."""
    return Hdf5Saver(h5group).save(obj, path)


def load_from_hdf5(h5group, path='/'):
    """Load from an open h5py group."""
    return Hdf5Loader(h5group).load(path)
