"""The port's multi-GPU layer (``video_depth_anything_torch/parallel``), the
parts that need no process group, against the JAX package: the window
spans of the multi-host pipeline, ZeRO-1's dimension choice, the pipeline's
microbatch count, tap placement and refusals, the tensor-parallel rules
mapped through the checkpoint bridge, the ranged decode, and the flags of
the port's ``run`` and ``train`` parsers against the root CLIs'."""

import importlib.util
import os
import re
import types
import warnings

import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec as PS

from tests.torch_port_helpers import configs, jax_param_shapes, one_torch_thread  # noqa: F401
from video_depth_anything_torch.io import video as t_video
from video_depth_anything_torch.io.checkpoint import from_jax_params
from video_depth_anything_torch.parallel import mesh as t_mesh
from video_depth_anything_torch.parallel import multihost as t_mh
from video_depth_anything_torch.parallel import pipeline_parallel as t_pp
from video_depth_anything_torch.run import build_parser as run_parser
from video_depth_anything_torch.run import check_parallel_args
from video_depth_anything_torch.train import __main__ as t_train_cli
from video_depth_anything_torch.train.trainer import zero1_spec
from video_depth_anything_tpu import config as jcfg
from video_depth_anything_tpu.io import video as j_video
from video_depth_anything_tpu.models.vda import VideoDepthAnything as JaxModule
from video_depth_anything_tpu.parallel import mesh as j_mesh
from video_depth_anything_tpu.parallel import multihost as j_mh
from video_depth_anything_tpu.parallel import pipeline_parallel as j_pp
from video_depth_anything_tpu.train.trainer import _zero1_spec

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAME_COUNTS = (1, 5, 31, 32, 33, 45, 46, 56, 57, 76, 100, 150, 301, 1000)


def _root_module(name: str):
    spec = importlib.util.spec_from_file_location(f"root_{name}_cli", os.path.join(ROOT, name))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("n_hosts", [1, 2, 3, 4, 8])
def test_host_window_spans_match_jax(n_hosts):
    for n in FRAME_COUNTS:
        got = [tuple(vars(s).values()) for s in t_mh.host_window_spans(n, n_hosts)]
        want = [tuple(vars(s).values()) for s in j_mh.host_window_spans(n, n_hosts)]
        assert got == want, n


def _jax_full_shapes(encoder: str):
    cfg = jcfg.get_model_config(encoder)
    return jax_param_shapes(JaxModule(cfg), np.zeros((1, 2, 28, 28, 3), np.float32))


@pytest.mark.parametrize("encoder", ["vits", "vitl"])
@pytest.mark.parametrize("data", [2, 3, 4, 8])
def test_zero1_spec_matches_jax(encoder, data):
    """Every trainable leaf of the JAX tree, with its TP spec, and the same
    leaf in the port's torch layout."""
    shapes = _jax_full_shapes(encoder)
    specs = j_mesh.param_partition_specs(shapes)
    leaves = jax.tree_util.tree_leaves_with_path(shapes)
    spec_leaves = jax.tree_util.tree_leaves(specs, is_leaf=lambda x: isinstance(x, PS))
    assert len(leaves) == len(spec_leaves)
    for (path, leaf), spec in zip(leaves, spec_leaves):
        for shape, sp in ((tuple(leaf.shape), spec), (tuple(leaf.shape)[::-1], PS(*spec[::-1]))):
            want = tuple(_zero1_spec(PS(*sp), shape, data))
            got = zero1_spec(tuple(sp), shape, data)
            assert got == want, (path, shape, sp)


@pytest.mark.parametrize("stages", [2, 3, 4])
def test_pick_microbatches_matches_jax(stages):
    runner = types.SimpleNamespace(S=stages, num_microbatches=None)
    for bt in range(1, 97):
        with warnings.catch_warnings(record=True) as jw:
            warnings.simplefilter("always")
            want = j_pp.PipelineParallelWindowRunner._pick_m(runner, bt)
        with warnings.catch_warnings(record=True) as tw:
            warnings.simplefilter("always")
            got = t_pp.pick_microbatches(bt, stages)
        assert got == want, bt
        assert [str(w.message) for w in tw] == [str(w.message) for w in jw], bt


@pytest.mark.parametrize("encoder", ["vits", "vitb", "vitl"])
@pytest.mark.parametrize("stages", [2, 3, 4])
def test_tap_placement_matches_jax(encoder, stages):
    """JAX ``_pp_encode_fn``'s static placement, as it computes it from the
    shipped config's taps."""
    cfg = jcfg.get_model_config(encoder)
    taps = tuple(int(i) for i in cfg.intermediate_layer_idx)
    per = cfg.vit.depth // stages
    stage_of = [t // per for t in taps]
    counts = [0] * stages
    slot_of = []
    for s in stage_of:
        slot_of.append(counts[s])
        counts[s] += 1
    assert t_pp.tap_placement(taps, per, stages) == (stage_of, slot_of, max(counts))
    assert t_pp.check_stages(cfg.vit.depth, stages) == per


@pytest.mark.parametrize("depth,stages", [(12, 5), (24, 7), (40, 3), (6, 4)])
def test_stage_refusal_matches_jax(depth, stages):
    with pytest.raises(ValueError) as want:
        j_pp.stack_block_params({}, depth, stages)
    with pytest.raises(ValueError) as got:
        t_pp.check_stages(depth, stages)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("bt,m", [(32, 5), (64, 3), (6, 4)])
def test_explicit_microbatch_refusal_matches_jax(bt, m):
    with pytest.raises(ValueError) as want:
        j_pp.PipelineParallelWindowRunner._pick_m(types.SimpleNamespace(S=2, num_microbatches=m),
                                                  bt)
    with pytest.raises(ValueError) as got:
        t_pp.pick_microbatches(bt, 2, m)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("encoder", ["vits", "vitb", "vitl"])
def test_tp_rules_map_through_the_bridge(encoder):
    """Each JAX leaf that ``param_partition_specs`` shards is marked along
    its sharded axis and sent through ``from_jax_params``: its torch tensor
    varies along the port rule's dimension only.  The motion modules'
    feed-forward leaves are the stated exception: no port rule."""
    jc, tc = configs(encoder, depth=2)
    shapes = jax_param_shapes(JaxModule(jc), np.zeros((1, 2, 28, 28, 3), np.float32))
    specs = j_mesh.param_partition_specs(shapes)

    def mark(path, leaf, spec):
        name = "/".join(str(getattr(k, "key", k)) for k in path)
        out = np.zeros(leaf.shape, np.float32)
        if "model" in tuple(spec):
            axis = tuple(spec).index("model")
            offset = 1e6 if any(re.search(p, name) for p in t_mesh.JAX_MOTION_FF_RULES) else 1.0
            shape = [1] * len(leaf.shape)
            shape[axis] = leaf.shape[axis]
            out += offset + np.arange(leaf.shape[axis], dtype=np.float32).reshape(shape)
        return out

    marked = jax.tree_util.tree_map_with_path(
        mark, shapes, specs, is_leaf=lambda x: isinstance(x, PS))
    state = from_jax_params(marked, jc)
    # the bridge synthesizes the position tables whatever the leaves hold
    blank = from_jax_params(jax.tree.map(lambda x: np.zeros(x.shape, np.float32), shapes), jc)
    seen_rule, seen_ff = set(), set()
    for name, t in state.items():
        t = np.asarray(t) - np.asarray(blank[name])
        if not t.any():
            assert t_mesh.rule_dim(name) is None, name
            continue
        varying = [d for d in range(t.ndim) if t.shape[d] > 1
                   and not np.all(t == np.take(t, [0], axis=d))]
        if t.max() >= 1e6:  # the motion feed-forward exception
            assert t_mesh.rule_dim(name) is None and ".ff." in name, name
            seen_ff.add(name)
            continue
        assert varying == [t_mesh.rule_dim(name)], (name, varying)
        seen_rule.add(re.sub(r"blocks\.\d+", "blocks.N", name))
    assert seen_rule == {f"pretrained.blocks.N.{n}" for n in (
        "attn.qkv.weight", "attn.qkv.bias", "attn.proj.weight", "mlp.fc1.weight",
        "mlp.fc1.bias", "mlp.fc2.weight")}
    # JAX ff/proj/kernel, ff/proj/bias and ff/out/kernel, in the torch names
    assert {n.split(".ff.")[1] for n in seen_ff} == {"net.0.proj.weight", "net.0.proj.bias",
                                                     "net.2.weight"}
    # and every port rule names a state-dict key the module has
    for pat, _ in t_mesh.TP_RULES:
        assert any(re.search(pat, n) for n in state), pat


@pytest.mark.parametrize("heads,ranks", [(6, 2), (6, 4), (16, 2), (16, 3), (12, 4)])
def test_qkv_rows_take_each_of_q_k_v(heads, ranks):
    """Whole heads, split unevenly where needed (vits' 6 on 4: 2, 2, 1, 1);
    each rank's rows are its heads' rows of q, then k, then v, and together
    the ranks hold every row once."""
    hd, dim = 64, heads * 64
    split = [t_mesh.head_split(heads, ranks, i) for i in range(ranks)]
    assert [len(s) for s in split] == [len(a) for a in np.array_split(np.arange(heads), ranks)]
    rows = [t_mesh.qkv_rows(s, hd, dim) for s in split]
    assert sorted(np.concatenate(rows).tolist()) == list(range(3 * dim))
    for s, r in zip(split, rows):
        third = len(r) // 3
        for p in range(3):
            part = r[p * third:(p + 1) * third]
            assert np.all(part // dim == p)
            assert sorted(set((part % dim) // hd)) == s.tolist()


def test_tp_refuses_more_ranks_than_heads():
    with pytest.raises(ValueError, match="cannot split"):
        t_mesh.head_split(6, 8, 0)


def _flags_of_help(text: str) -> set:
    return set(re.findall(r"--\w+", text))


def test_run_flags_match_jax(capsys):
    jax_flags = {a for act in _root_module("run.py").build_parser()._actions
                 for a in act.option_strings if a.startswith("--")}
    port_flags = {a for act in run_parser()._actions for a in act.option_strings
                  if a.startswith("--")}
    assert jax_flags == port_flags - {"--device"}
    for flag in ("--data_parallel", "--model_parallel", "--pipeline_parallel", "--pp_microbatches",
                 "--coordinator", "--num_hosts", "--host_id"):
        assert flag in port_flags


def test_run_multihost_env_defaults(monkeypatch):
    monkeypatch.setenv("VDA_COORDINATOR", "10.0.0.1:1234")
    monkeypatch.setenv("VDA_NUM_HOSTS", "4")
    monkeypatch.setenv("VDA_HOST_ID", "3")
    jax_args = _root_module("run.py").build_parser().parse_args(["--input_video", "v"])
    args = run_parser().parse_args(["--input_video", "v"])
    for k in ("coordinator", "num_hosts", "host_id", "model_parallel", "pipeline_parallel",
              "pp_microbatches", "data_parallel"):
        assert getattr(args, k) == getattr(jax_args, k), k
    assert (args.coordinator, args.num_hosts, args.host_id) == ("10.0.0.1:1234", 4, 3)


def test_train_flags_match_jax(capsys):
    with pytest.raises(SystemExit):
        _root_module("train.py").main(["--help"])
    jax_flags = _flags_of_help(capsys.readouterr().out)
    port_flags = {a for act in t_train_cli.build_parser()._actions for a in act.option_strings
                  if a.startswith("--")}
    assert jax_flags == port_flags - {"--device"}
    args = t_train_cli.build_parser().parse_args(["--dataset", "kitti", "--root", "r"])
    assert (args.model_parallel, args.zero1) == (1, False)


@pytest.mark.parametrize("flags,message", [
    (["--pipeline_parallel", "2", "--data_parallel"],
     "--pipeline_parallel is exclusive with --data_parallel/--model_parallel"),
    (["--pipeline_parallel", "2", "--model_parallel", "2"],
     "--pipeline_parallel is exclusive with --data_parallel/--model_parallel"),
    (["--pipeline_parallel", "2", "--process_single_image"],
     "--pipeline_parallel applies to the sliding-window mode only "
     "(not --process_single_image/--kv_cache/--coordinator)"),
    (["--pipeline_parallel", "2", "--coordinator", "h:1"],
     "--pipeline_parallel applies to the sliding-window mode only "
     "(not --process_single_image/--kv_cache/--coordinator)"),
    (["--num_hosts", "2", "--process_single_image"],
     "--coordinator/--num_hosts is sliding-window only "
     "(windows shard across hosts; streaming is sequential)"),
])
def test_run_parallel_refusals_carry_jax_messages(flags, message):
    """The messages are the root ``run.py``'s (its source holds each)."""
    source = re.sub(r'"\s*\n\s*"', "", open(os.path.join(ROOT, "run.py")).read())
    assert message in source
    args = run_parser().parse_args(["--input_video", "v"] + flags)
    multihost = args.coordinator is not None or (args.num_hosts or 1) > 1
    with pytest.raises(SystemExit, match=re.escape(message)):
        check_parallel_args(args, multihost)


def test_ranged_decode_matches_jax(tmp_path, monkeypatch):
    """``count_video_frames`` and ``read_video_frame_range`` against JAX's
    on one written clip (the seek path, the grab path, fps striding and the
    header check), and against the port's whole-clip decode."""
    monkeypatch.setenv("VDA_NATIVE_DECODE", "0")
    rng = np.random.RandomState(5)
    base = (rng.rand(37, 32, 48, 3) * 255).astype(np.uint8)
    video = str(tmp_path / "v.mp4")
    t_video.save_video(base, video, fps=24)
    full, fps = t_video.read_video_frames(video)
    assert t_video.count_video_frames(video) == j_video.count_video_frames(video) == (37, fps)
    assert t_video.count_video_frames(video, 20, 12) == j_video.count_video_frames(video, 20, 12)
    for a, b in ((0, 5), (10, 25), (30, 37)):
        got = t_video.read_video_frame_range(video, a, b)
        np.testing.assert_array_equal(got, j_video.read_video_frame_range(video, a, b))
        np.testing.assert_array_equal(got, full[a:b])
    strided, _ = t_video.read_video_frames(video, target_fps=12)
    got = t_video.read_video_frame_range(video, 3, 9, target_fps=12)
    np.testing.assert_array_equal(got, strided[3:9])
    np.testing.assert_array_equal(got, j_video.read_video_frame_range(video, 3, 9, 12))
    monkeypatch.setenv("VDA_SEEK_MODE", "grab")
    np.testing.assert_array_equal(t_video.read_video_frame_range(video, 10, 25), full[10:25])
    monkeypatch.setenv("VDA_VALIDATE_FRAME_COUNT", "1")
    assert t_video.count_video_frames(video)[0] == 37
    with pytest.raises(ValueError, match="decoded"):
        t_video.read_video_frame_range(video, 30, 40)


def test_initialize_distributed_is_a_no_op_for_one_process():
    """As JAX's ``initialize_distributed`` (``multihost.py:19-38``)."""
    assert t_mh.initialize_distributed() == j_mh.initialize_distributed() == (0, 1)
    assert t_mh.initialize_distributed(None, 1, 0) == (0, 1)


@pytest.mark.parametrize("keys,backend", [
    (["GPU-a", "GPU-b"], "nccl"),  # two nodes of one host name, a card each
    (["GPU-a", "GPU-b", "GPU-c", "GPU-d"], "nccl"),
    (["GPU-a", "GPU-a"], "gloo"),  # two ranks on one card
    (["GPU-a", "GPU-b", "GPU-a"], "gloo"),
    (["cpu", "cpu"], "gloo"),
    (["cpu"], "gloo"),
])
def test_backend_rule_tells_devices_apart_by_card(keys, backend):
    from video_depth_anything_torch.parallel import comm

    assert comm.backend_for(keys) == backend


def test_device_key_is_the_card_uuid_not_the_host(monkeypatch):
    """Two nodes that share a host name (sandboxes, containers) each bind
    ``cuda:0``: their keys differ by the cards' UUIDs, so they get NCCL."""
    import socket

    import torch

    from video_depth_anything_torch.parallel import comm

    monkeypatch.setattr(socket, "gethostname", lambda: "runsc")
    keys = []
    for uuid in ("9b1c-0001", "9b1c-0002"):
        monkeypatch.setattr(torch.cuda, "get_device_properties",
                            lambda dev, u=uuid: types.SimpleNamespace(uuid=u))
        keys.append(comm.device_key(torch.device("cuda", 0)))
    assert keys == ["GPU-9b1c-0001", "GPU-9b1c-0002"]
    assert comm.backend_for(keys) == "nccl"
    assert comm.device_key(torch.device("cpu")) == "cpu"


@pytest.mark.parametrize("flags", [["--streaming"], ["--kv_cache"], ["--data_parallel"],
                                   ["--model_parallel", "2"]])
def test_eval_pipeline_parallel_refusal_matches_jax(flags):
    """The root ``eval.py`` refuses before it imports JAX; the port's
    ``eval`` with the same message."""
    from video_depth_anything_torch import eval as t_eval

    argv = ["--dataset", "sintel", "--root", "r", "--csv", "c", "--pipeline_parallel", "2"] + flags
    with pytest.raises(SystemExit) as want:
        _root_module("eval.py").main(argv)
    with pytest.raises(SystemExit) as got:
        t_eval.main(argv)
    assert str(got.value) == str(want.value) and "--pipeline_parallel" in str(got.value)
