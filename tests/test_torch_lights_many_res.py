"""The plain K2 and K3 at 33 lights (tests/test_torch_cuda.py many_lights,
nee="single", the random sampler, shadow="robust", 1,024 lanes, depth 1)
against kytpu's interpreted K2 and K3 through each package's diff tracer:
the gradients within rtol=1e-4 plus 1e-6 of each table's largest entry,
the cache's float planes and row bits as test_torch_wavefront_res.py holds
them (kytpu has no pick plane: the port's first max_depth + 1 int planes).
kytpu's K3 recomputes the single-light pick, right under the random
sampler only (ROADMAP section 3), so this is the sampler that compares."""

from tests.test_torch_wavefront_res import cache_agrees, grads_agree, \
    trace_grads
import tests.torch_threads  # noqa: F401  (one torch thread a process)


def test_k2_k3_past_32_lights_match_kytpu():
    got, ref, static = trace_grads("many_lights33", "random", "single",
                                   n=1024, shadow="robust", max_depth=1)
    assert len(static["lights"]) == 33
    grads_agree(got[1], ref[1], static)
    # the port keeps the pick in an int plane of its own past 32 lights
    # (kytpu's K3 recomputes it), and nothing in bits 11-15
    assert got[3].shape[0] == 2 * 1 + 1 and ref[3].shape[0] == 2
    live = got[3][0] != 0
    assert ((got[3][2][live] >= 0) & (got[3][2][live] < 33)).all()
    assert not (got[3][:2] & (31 << 11)).any()
    cache_agrees((got[2], got[3][:2]), ref[2:])


