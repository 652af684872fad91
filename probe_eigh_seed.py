"""The float32 seed of the split's ``'qr_eigh32'`` backend on the chi=512
complex128 TEBD bond update of ``chip_smoke.py`` phase 8, on the card.

Builds phase 8's state (the XXZ ground state, quenched to chi=512), takes
one bond update's theta and split plan as phase 19b does, and for each
bucket group eighs its Gram matrix ``M^H M`` (with the f64 shift of
``_decomp_qr_eigh``) in complex64 four ways: as it is (as ``tenpy_tpu``
casts it), with a shift of 1e-6 of its trace, divided by its trace (what
``_decomp_qr_eigh`` does where the trace is not 0; here also where it is,
which fails), and both; on the card and on the host.  Per
group and way it prints whether the eigh converged and, where it did,
the largest deviation of the resulting Schmidt values (f64 Rayleigh
quotients of the QR-orthonormalized seed) from the SVD's, relative to the
group's largest::

    python3 probe_eigh_seed.py
"""
import torch

import chip_smoke as cs
from tenpy_tpu_torch.linalg import packed as pk
from tenpy_tpu_torch.linalg import packed_split as ps

WAYS = (('as it is', 1e-13, False), ('shift 1e-6', 1e-6, False),
        ('divided by its trace', 1e-13, True),
        ('divided, shift 1e-6', 1e-6, True))


def seed_error(rho, M, shift_rel, divide, device):
    """The Schmidt values' largest deviation from the SVD's (relative to
    the largest) of one way to seed, or the eigh's error."""
    C = rho.shape[-1]
    tr = torch.diagonal(rho, dim1=-2, dim2=-1).sum(-1).real
    r = rho + ((shift_rel / C) * tr)[:, None, None] * torch.eye(
        C, dtype=rho.dtype, device=rho.device)
    if divide:
        r = r / tr[:, None, None]
    try:
        _, V0 = torch.linalg.eigh(r.to(torch.complex64).to(device))
    except torch.linalg.LinAlgError as e:
        return f"{type(e).__name__}: {str(e)[:80]}"
    V, _ = torch.linalg.qr(V0.to(M.device).to(M.dtype).flip(-1))
    w = (V.conj() * (rho @ V)).sum(-2).real
    S = torch.sqrt(torch.clamp(torch.sort(w, descending=True).values, min=0))
    ref = torch.linalg.svdvals(M)
    return f"ok, {float((S - ref).abs().max() / ref.max()):.2e}"


def main():
    smi = cs.phase_device()
    cs.phase_build()
    eng, _, _ = cs.phase_tebd_quench(cs.phase_tebd_ground_state(), smi)
    B0, B1, S0, U = eng.Bp[0], eng.Bp[1], eng.Sp[0], eng.Up[1][1]
    plan = ps.split_plan(eng._theta_struct(B0, B1, U), eng._bond(1),
                         eng.qtotal_site[0])
    C = pk.tensordot(B0.replace_labels(['p'], ['p0']),
                     B1.replace_labels(['p'], ['p1']), axes=(['vR'], ['vL']))
    C = pk.tensordot(U, C, axes=(['p0*', 'p1*'], ['p0', 'p1']))
    th = ps.scale_bond(C.transpose(['vL', 'p0', 'p1', 'vR']), S0,
                       ps.scale_bond_plan(C.transpose(['vL', 'p0', 'p1',
                                                       'vR']), 'vL'))
    tb = plan.tables(th.device)
    flat = torch.cat([d.reshape(-1) for d in th.data]
                     + [th.data[0].new_zeros(1)])
    for g, (gidx, _) in zip(plan.groups, tb['groups']):
        M = flat[gidx].reshape(g.N, g.R, g.C)
        if g.R < g.C:
            M = M.conj().transpose(-1, -2)
        rho = M.conj().transpose(-1, -2) @ M
        tr = torch.diagonal(rho, dim1=-2, dim2=-1).sum(-1).real
        print(f"group N={g.N} R={g.R} C={g.C}: traces "
              f"{[f'{t:.2e}' for t in tr.tolist()]}, zero columns "
              f"{int((M.abs().sum(-2) == 0).sum())}", flush=True)
        for name, shift_rel, divide in WAYS:
            for device in ('cuda', 'cpu'):
                print(f"  {name:22s} {device}: "
                      f"{seed_error(rho, M, shift_rel, divide, device)}",
                      flush=True)


if __name__ == '__main__':
    main()
