"""The port's output formats and tools against ``tenpy_tpu``'s.

* HDF5 interchange: both committed files of ``tests/export_import/data``
  (written by ``tenpy_tpu`` and by reference TeNPy 1.1.0) load into the
  port's objects equal to ``tenpy_tpu``'s load of the same files (dense
  tensors exact, leg charges and ``qconj`` equal, Schmidt values 1e-14;
  ``tests/test_torch_simulation.py`` checks in a subprocess that these
  loads import no JAX); a file the port writes loads
  into ``tenpy_tpu`` equal to its own example data (the port stamps the
  reference module paths).  Only these cross-loads import JAX, and they
  only read files.
* The port's twin of ``tests/test_hdf5_io.py``'s example data round-trips
  through ``.h5``, ``.pkl`` and ``.pkl.gz``; a CUDA tensor would be
  pickled from the host.
* A pickle that names a class or function of ``tenpy_tpu``, of the
  reference library or of JAX is refused before anything is imported
  (``tests/test_torch_simulation.py`` checks a JAX-written results pickle
  in a process without JAX).
* The cache storages, the worker thread and ``Config``, as
  ``tests/test_tools.py`` tests ``tenpy_tpu``'s.
"""
import os
import pickle
import warnings

import numpy as np
import pytest
import torch

h5py = pytest.importorskip('h5py')

from tenpy_tpu_torch.linalg import np_conserved as npc  # noqa: E402
from tenpy_tpu_torch.linalg.charges import ChargeInfo, LegCharge, \
    LegPipe  # noqa: E402
from tenpy_tpu_torch.networks.mpo import MPO  # noqa: E402
from tenpy_tpu_torch.networks.mps import MPS  # noqa: E402
from tenpy_tpu_torch.networks.site import FermionSite, Site, \
    SpinHalfSite  # noqa: E402
from tenpy_tpu_torch.tools import io as tio  # noqa: E402
from tenpy_tpu_torch.tools.cache import CacheFile, DictCache, \
    PickleStorage, ThreadedStorage  # noqa: E402
from tenpy_tpu_torch.tools.params import Config, asConfig  # noqa: E402
from tenpy_tpu_torch.tools.thread import Worker  # noqa: E402

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATADIR = os.path.join(ROOT, 'tests', 'export_import', 'data')
FILES = ['exported_from_0.1.0.dev0.h5', 'exported_from_ref_tenpy_1.1.0.h5']


def gen_port_example_data():
    """The port's twin of ``tests/test_hdf5_io.py``'s ``gen_example_data``
    (the same values and objects, built by the port)."""
    from tenpy_tpu_torch.models.tf_ising import TFIChain
    s = SpinHalfSite('Sz')
    psi = MPS.from_product_state([s] * 4, ['up', 'down', 'up', 'down'])
    M = TFIChain({'L': 4, 'J': 1., 'g': 0.5, 'bc_MPS': 'finite'})
    shared = np.arange(20).reshape(4, 5)
    return {
        'None': None,
        'scalars': [0, np.int64(1), 2., np.float64(0.5), 3. + 4.j, 'text',
                    True, False],
        'big_int': 2 ** 70,
        'bytes': b'\x00\x01binary',
        'range': range(2, 20, 3),
        'dtype': np.dtype([('a', np.int32), ('b', np.float64)]),
        'arrays': {'int': np.arange(12).reshape(3, 4),
                   'complex': np.exp(1.j * np.arange(4)),
                   'shared1': shared, 'shared2': shared},
        'iterables': {'list': [1, 'a', None], 'tuple': (2, [3, 4], 'b'),
                      'set': {1, 2, 'x'}},
        'nonsimple_keys': {(1, 2): 'tuple key', 3: 'int key',
                           'with/slash': 'bad path'},
        'npc': {'chinfo': psi.chinfo, 'leg': psi._B[1].get_leg('vL'),
                'array': psi._B[1], 'site': s},
        'mps': psi,
        'mpo': M.H_MPO,
    }


def _dense(a):
    """A dense numpy array of an Array of either package."""
    return np.asarray(a.to_numpy())


def assert_same(got, exp, path='root', S_tol=1e-14):
    """``got`` (the port's) equal to ``exp`` (the port's or
    ``tenpy_tpu``'s), recursively; classes are compared by name."""
    name = type(exp).__name__
    if isinstance(exp, dict):
        assert set(got) == set(exp), path
        for k in exp:
            assert_same(got[k], exp[k], f"{path}[{k!r}]", S_tol)
    elif isinstance(exp, (list, tuple)):
        assert type(got) is type(exp) and len(got) == len(exp), path
        for i, (g, e) in enumerate(zip(got, exp)):
            assert_same(g, e, f"{path}[{i}]", S_tol)
    elif isinstance(exp, (set, np.dtype, range)) or exp is None or \
            np.isscalar(exp):
        assert type(got) is type(exp) and got == exp, (path, got, exp)
    elif isinstance(exp, np.ndarray):
        np.testing.assert_array_equal(got, exp, err_msg=path)
    elif name in ('Array',):
        assert isinstance(got, npc.Array), path
        assert tuple(got.get_leg_labels()) == tuple(exp.get_leg_labels())
        assert tuple(got.qtotal) == tuple(int(q) for q in exp.qtotal)
        for lg, le in zip(got.legs, exp.legs):
            assert_same(lg, le, path + '.leg', S_tol)
        np.testing.assert_array_equal(_dense(got), _dense(exp),
                                      err_msg=path)
    elif name == 'ChargeInfo':
        assert isinstance(got, ChargeInfo), path
        assert tuple(got.mod) == tuple(exp.mod) and \
            tuple(got.names) == tuple(exp.names), path
    elif name in ('LegCharge', 'LegPipe'):
        assert type(got).__name__ == name, path
        np.testing.assert_array_equal(np.asarray(got.slices),
                                      np.asarray(exp.slices), err_msg=path)
        np.testing.assert_array_equal(np.asarray(got.charges),
                                      np.asarray(exp.charges), err_msg=path)
        assert got.qconj == exp.qconj, path
    elif name == 'MPS':
        assert isinstance(got, MPS) and got.L == exp.L and got.bc == exp.bc
        assert_same(got.sites, exp.sites, path + '.sites', S_tol)
        assert_same(got._B, exp._B, path + '._B', S_tol)
        for b in range(1, exp.L):
            np.testing.assert_allclose(np.asarray(got.get_SL(b)),
                                       np.asarray(exp.get_SL(b)),
                                       rtol=0, atol=S_tol, err_msg=path)
        assert abs(float(got.norm) - float(exp.norm)) <= 1e-14
    elif name == 'MPO':
        assert isinstance(got, MPO) and got.L == exp.L and got.bc == exp.bc
        assert_same(got._W, exp._W, path + '._W', S_tol)
        assert list(got.IdL) == list(exp.IdL) and \
            list(got.IdR) == list(exp.IdR), path
    elif hasattr(exp, 'opnames'):       # a Site
        assert isinstance(got, Site) and type(got).__name__ == name, path
        assert got.opnames == exp.opnames, path
        assert_same(got.leg, exp.leg, path + '.leg', S_tol)
        for op in exp.opnames:
            np.testing.assert_array_equal(_dense(getattr(got, op)),
                                          _dense(getattr(exp, op)),
                                          err_msg=f"{path}.{op}")
    else:
        raise AssertionError(f"don't know how to compare {type(exp)} at "
                             f"{path}")


@pytest.fixture(scope='module')
def jax_loads():
    """``tenpy_tpu``'s loads of the committed files (JAX on the CPU)."""
    import jax
    jax.config.update('jax_platforms', 'cpu')
    jax.config.update('jax_enable_x64', True)
    from tenpy_tpu.tools import io as jio
    return {f: jio.load(os.path.join(DATADIR, f)) for f in FILES}


@pytest.mark.parametrize('fn', FILES)
def test_load_committed_file_vs_jax(fn, jax_loads):
    """The port's load equals JAX's, and its MPS is the example state
    (|overlap| 1 within 1e-12)."""
    loaded = tio.load(os.path.join(DATADIR, fn))
    assert type(loaded['mps']) is MPS
    assert_same(loaded, jax_loads[fn])
    ov = loaded['mps'].overlap(gen_port_example_data()['mps'])
    assert abs(abs(complex(ov)) - 1.) < 1e-12


@pytest.mark.parametrize('ext', ['.h5', '.pkl', '.pkl.gz'])
def test_roundtrip(ext, tmp_path):
    data = gen_port_example_data()
    fn = str(tmp_path / ('example' + ext))
    tio.save(data, fn)
    loaded = tio.load(fn)
    assert_same(loaded, data)
    if ext == '.h5':
        assert loaded['arrays']['shared1'] is loaded['arrays']['shared2']


def test_port_file_loads_into_jax(tmp_path, jax_loads):
    """A file the port saves loads into ``tenpy_tpu`` objects equal to
    ``tenpy_tpu``'s own example data (``tests/test_hdf5_io.py``'s check);
    the reference module paths are on disk."""
    import test_hdf5_io as th
    from tenpy_tpu.networks.mps import MPS as JMPS
    from tenpy_tpu.tools import io as jio
    fn = str(tmp_path / 'port.h5')
    tio.save(gen_port_example_data(), fn)
    with h5py.File(fn, 'r') as f:
        assert f['mps'].attrs['module'] == 'tenpy.networks.mps'
        assert f['npc/array'].attrs['module'] == 'tenpy.linalg.np_conserved'
        assert f['npc/site'].attrs['module'] == 'tenpy.networks.site'
    loaded = jio.load(fn)
    assert type(loaded['mps']) is JMPS
    th.assert_equal_data(loaded, th.gen_example_data())


def test_hdf5_pipe_roundtrip(tmp_path):
    """A LegPipe and a combined-leg Array survive the round trip, and the
    loaded pipe splits again."""
    s = FermionSite('N')
    a = npc.outer(s.N.replace_labels(['p', 'p*'], ['p0', 'p0*']),
                  s.Id.replace_labels(['p', 'p*'], ['p1', 'p1*']))
    a = a.combine_legs([['p0', 'p1'], ['p0*', 'p1*']], qconj=[+1, -1])
    fn = str(tmp_path / 'pipe.h5')
    tio.save(a, fn)
    b = tio.load(fn)
    assert isinstance(b.legs[0], LegPipe)
    assert_same(b, a)
    np.testing.assert_array_equal(_dense(b.split_legs()),
                                  _dense(a.split_legs()))


def test_no_cuda_tensor_in_pickles():
    """The pickler writes a CUDA tensor from the host (checked on its
    reducer: no card here)."""
    p = tio._HostPickler(__import__('io').BytesIO())
    t = torch.arange(3.)
    assert p.reducer_override(t) is NotImplemented
    assert p.reducer_override(np.arange(3)) is NotImplemented
    if torch.cuda.is_available():
        buf = __import__('io').BytesIO()
        tio.save_pickle({'x': t.cuda()}, buf)
        assert pickle.loads(buf.getvalue())['x'].device.type == 'cpu'


@pytest.mark.parametrize('container', ['.pkl', '.pkl.gz', '.h5'])
@pytest.mark.parametrize('name', ['tenpy_tpu.networks.mps.MPS',
                                  'tenpy.linalg.np_conserved.Array',
                                  'jax._src.array._reconstruct_array'])
def test_foreign_pickle_refused(name, container, tmp_path):
    """A pickle (a file, or a raw pickle node of an HDF5 file) naming a
    global of ``tenpy_tpu``, the reference library or JAX raises
    ``Hdf5ImportError`` with its name and the advice to save as .h5; the
    same pickle naming the port's class loads."""
    import gzip
    module, qualname = name.rsplit('.', 1)

    def write(fn, module):
        raw = f"c{module}\n{qualname}\n.".encode()
        if container == '.h5':
            with h5py.File(fn, 'w') as f:
                f.attrs['type'] = 'simple_dict'
                f['x'] = np.frombuffer(raw, np.uint8)
                f['x'].attrs['type'] = 'pickle'
        else:
            with (gzip.open if container == '.pkl.gz' else open)(
                    fn, 'wb') as f:
                f.write(raw)

    fn = str(tmp_path / ('foreign' + container))
    write(fn, module)
    with pytest.raises(tio.Hdf5ImportError, match=r'\.h5') as err:
        tio.load(fn)
    assert name in str(err.value)
    if module.startswith('tenpy'):
        own = 'tenpy_tpu_torch.' + module.split('.', 1)[1]
        write(fn, own)
        got = tio.load(fn)
        got = got['x'] if container == '.h5' else got
        assert got.__module__ == own and got.__qualname__ == qualname


@pytest.mark.parametrize('storage', ['Storage', 'PickleStorage',
                                     'Hdf5Storage'])
@pytest.mark.parametrize('threading', [False, True])
def test_cache_storages(storage, threading, tmp_path):
    """Every storage class behind ``CacheFile``, with and without the
    worker thread: saves, short-term keys, preloads, deletes; values with
    torch tensors and Arrays come back equal (a bare tensor as numpy from
    HDF5, as ``tenpy_tpu``'s JAX arrays do)."""
    psi = MPS.from_product_state([SpinHalfSite('Sz')] * 2, ['up', 'down'])
    with CacheFile.open(storage_class=storage, tmpdir=str(tmp_path),
                        use_threading=threading) as c:
        inner = c.storage.storage if isinstance(c.storage, ThreadedStorage) \
            else c.storage
        assert type(inner).__name__ == storage
        assert isinstance(c.storage, ThreadedStorage) == \
            (threading and storage != 'Storage')
        for i in range(4):
            c[f'k{i}'] = {'arr': np.full(4, i), 'tag': f't{i}',
                          't': torch.full((2,), float(i)), 'B': psi._B[i % 2]}
        c.set_short_term_keys('k0', 'k1')
        c.preload('k2', 'k3')
        for i in range(4):
            v = c[f'k{i}']
            assert np.all(v['arr'] == i) and v['tag'] == f't{i}'
            # HDF5 has no torch type: a bare tensor comes back as numpy
            assert isinstance(v['t'], np.ndarray if storage == 'Hdf5Storage'
                              else torch.Tensor)
            np.testing.assert_array_equal(np.asarray(v['t']),
                                          np.full(2, float(i)))
            assert_same(v['B'], psi._B[i % 2])
        del c['k0']
        assert 'k0' not in c and 'k1' in c
        sub = c.create_subcache('env')
        sub['y'] = 3
        assert sub['y'] == 3 and 'env/y' in c


def test_pickle_storage_directory(tmp_path):
    """``PickleStorage`` keeps one file per key and removes its directory
    on close."""
    st = PickleStorage.open(tmpdir=str(tmp_path))
    st.save('a/b', [1, 2])
    assert os.listdir(st.directory) == ['a_b.pkl']
    assert st.load('a/b') == [1, 2]
    st.close()
    assert not os.path.exists(st.directory)


def test_worker_thread():
    results = {}
    with Worker('test') as w:
        w.put_task(lambda a, b: a + b, 2, 3, return_dict=results,
                   return_key='sum')
        w.put_task(np.square, np.arange(3), return_dict=results,
                   return_key='sq')
        w.join_tasks()
    assert results['sum'] == 5
    assert np.all(results['sq'] == [0, 1, 4])


def test_config():
    """Unused keys warned about (recursively), the dict interface, and
    pickling."""
    cfg = asConfig({'a': 1, 'typo_key': 2, 'sub': {'b': 3, 'typo2': 4}},
                   'test')
    assert cfg.get('a', 0, int) == 1
    assert cfg.subconfig('sub').get('b', 0) == 3
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter('always')
        cfg.warn_unused(recursive=True)
    msgs = ' '.join(str(x.message) for x in w)
    assert 'typo_key' in msgs and 'typo2' in msgs
    cfg.touch('typo_key')
    assert 'typo_key' not in cfg.unused
    c2 = pickle.loads(pickle.dumps(cfg))
    assert c2.as_dict() == {'a': 1, 'typo_key': 2,
                            'sub': {'b': 3, 'typo2': 4}}
    assert sorted(c2) == ['a', 'sub', 'typo_key'] and len(c2) == 3
    del c2['a']
    c2.update({'z': 5})
    assert dict(c2.items())['z'] == 5 and 'z' in c2.unused
    assert isinstance(c2.copy(), Config)


def test_dict_cache_trivial():
    c = DictCache.trivial()
    c['x'] = np.arange(5)
    assert np.all(c['x'] == np.arange(5)) and 'x' in c
