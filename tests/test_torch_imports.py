"""The port stands alone: genrec_tpu_torch imports neither jax nor the JAX
package (nor does reading the repo's gin files through its configlib),
importing it loads no ``transformers`` (the card has none; only a caller
naming a tokenizer or checkpoint loads it), its entry points default to
the card, and chip_smoke.py refuses to report anything without one.
"""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from genrec_tpu_torch.catalog.snapshot import CatalogSnapshot
from genrec_tpu_torch.catalog.tensor_trie import TensorTrie
from genrec_tpu_torch.device import resolve_device
from genrec_tpu_torch.models.embeddings import SemIdEmbedding, UserIdEmbedding
from genrec_tpu_torch.models.layers import RMSNorm
from genrec_tpu_torch.models.t5transformer import (
    T5Attention,
    T5FeedForward,
    TransformerBlock,
    TransformerDecoder,
    TransformerEncoder,
    TransformerEncoderDecoder,
)
from genrec_tpu_torch.models.cobra import (
    Cobra,
    CobraDecoder,
    CobraEmbedding,
    LightT5Encoder,
    init_cobra_paged_state,
)
from genrec_tpu_torch.models.rqvae import RqVae
from genrec_tpu_torch.models.tiger import Tiger
from genrec_tpu_torch.models.sasrec import SASRec, SASRecBlock
from genrec_tpu_torch.serving.engine import ServingEngine
from genrec_tpu_torch.serving.heads import (
    CobraGenerativeHead,
    LCRecGenerativeHead,
    NoteLLMRetrievalHead,
    RetrievalHead,
    TigerGenerativeHead,
)
from genrec_tpu_torch.core.lora import LoraAdapters, lora_init, lora_merge
from genrec_tpu_torch.data.notellm_pairs import NoteLLMPairData
from genrec_tpu_torch.models.notellm import NoteLLM, query2embedding_forward
from genrec_tpu_torch.trainers import notellm_trainer
from genrec_tpu_torch.ops.spec_tree import TreeTopology, tree_topology
from genrec_tpu_torch.serving.kv_pool import KVPagePool, PagedConfig, PrefixIndex

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "genrec_tpu")
#: The live planes' and the trainers' fault-tolerance modules, each a port
#: of a JAX module that imports jax or orbax (checkpoint) or that the JAX
#: engine or trainers reach through them.
LIVE_MODULES = ("genrec_tpu_torch.obs", "genrec_tpu_torch.obs.spans",
                "genrec_tpu_torch.obs.flight_recorder", "genrec_tpu_torch.obs.slo",
                "genrec_tpu_torch.obs.export", "genrec_tpu_torch.obs.memory",
                "genrec_tpu_torch.core.checkpoint", "genrec_tpu_torch.core.preemption",
                "genrec_tpu_torch.serving.catalog",
                # The trainers' fault tolerance (ports of JAX modules importing jax).
                "genrec_tpu_torch.core.fault_tolerance", "genrec_tpu_torch.core.chaos",
                "genrec_tpu_torch.obs.goodput",
                # The Amazon data paths (copies of framework-free JAX modules)
                # and the two-stage runner.
                "genrec_tpu_torch.native", "genrec_tpu_torch.native.loader",
                "genrec_tpu_torch.data.amazon", "genrec_tpu_torch.data.p5_amazon",
                "genrec_tpu_torch.pipelines",
                # The Qwen families' rest: NoteLLM (a copy of the JAX pair
                # data, the model, the trainer) and LoRA.
                "genrec_tpu_torch.models.notellm", "genrec_tpu_torch.data.notellm_pairs",
                "genrec_tpu_torch.trainers.notellm_trainer", "genrec_tpu_torch.core.lora",
                # The continuous pipeline: the stream log (a copy of the JAX
                # package's framework-free module), the streaming trainer and
                # the rollout guard.
                "genrec_tpu_torch.data.stream_log", "genrec_tpu_torch.trainers.stream_trainer",
                "genrec_tpu_torch.serving.rollout")

# Runs in a fresh interpreter: jax and friends are poisoned in
# sys.modules, and a meta-path hook refuses genrec_tpu and genrec_tpu.*
# (but not genrec_tpu_torch, whose name only shares the prefix).
_IMPORT_EVERY_MODULE = r"""
import importlib, importlib.abc, pkgutil, sys

FORBIDDEN = %r
LIVE_MODULES = %r
for name in FORBIDDEN[:-1]:
    sys.modules[name] = None

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name == "genrec_tpu" or name.startswith("genrec_tpu."):
            raise ImportError(f"the port imported {name}")
        return None

sys.meta_path.insert(0, Refuse())
import genrec_tpu_torch

names = ["genrec_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(genrec_tpu_torch.__path__, "genrec_tpu_torch.")
]
for name in names:
    importlib.import_module(name)
assert "genrec_tpu_torch.ops.spec_tree" in names, names
missing = [m for m in LIVE_MODULES if m not in names]
assert not missing, missing
leaked = sorted(
    n for n, m in sys.modules.items()
    if m is not None and n.split(".")[0] in FORBIDDEN
)
assert not leaked, leaked
# transformers loads only where a caller names a tokenizer or checkpoint.
assert "transformers" not in sys.modules
print(len(names))
""" % (FORBIDDEN, LIVE_MODULES)


# Parse a gin file that names the JAX package through the port's
# configlib, in a fresh interpreter that refuses jax and genrec_tpu.
_PARSE_GIN = _IMPORT_EVERY_MODULE.split("import genrec_tpu_torch\n")[0] + r"""
from genrec_tpu_torch import configlib
from genrec_tpu_torch.configlib import registry
from genrec_tpu_torch.trainers import rqvae_trainer

configlib.parse_file(sys.argv[1], substitutions={"split": "beauty"})
b = configlib.get_bindings("genrec_tpu_torch.trainers.rqvae_trainer.train")
from genrec_tpu_torch.models.rqvae import QuantizeForwardMode as Q
assert b["vae_codebook_mode"] is Q.STE, b["vae_codebook_mode"]
assert b["vae_codebook_last_layer_mode"] is Q.SINKHORN
assert b["vae_input_dim"] == int(sys.argv[2]), b["vae_input_dim"]
assert registry.resolve_enum("genrec_tpu.models.rqvae.QuantizeDistance.L2").name == "L2"
assert registry.lookup("genrec_tpu.trainers.rqvae_trainer.train") is rqvae_trainer.train
leaked = sorted(
    n for n, m in sys.modules.items()
    if m is not None and n.split(".")[0] in FORBIDDEN
)
assert not leaked, leaked
print("ok")
"""


@pytest.mark.parametrize("gin,input_dim", [("config/tiger/amazon/rqvae.gin", 768),
                                           ("config/rqvae/synthetic.gin", 64)])
def test_gin_files_naming_the_jax_package_parse_without_it(gin, input_dim):
    """``import genrec_tpu.models.rqvae`` and ``%genrec_tpu.models.rqvae.
    QuantizeForwardMode.STE`` read as the port's names; afterwards neither
    jax nor genrec_tpu is in sys.modules."""
    proc = subprocess.run([sys.executable, "-c", _PARSE_GIN, gin, str(input_dim)], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and proc.stdout.split()[-1] == "ok", proc.stderr


_GIN_IMPORTS = _IMPORT_EVERY_MODULE.split("import genrec_tpu_torch\n")[0] + r"""
from genrec_tpu_torch import configlib
from genrec_tpu_torch.configlib import registry

for name in ("tiger_trainer", "cobra_trainer", "notellm_trainer"):
    configlib.parse_string(f"import genrec_tpu.trainers.{name}")
    port = sys.modules[f"genrec_tpu_torch.trainers.{name}"]
    assert registry.lookup(f"genrec_tpu.trainers.{name}.train") is port.train
configlib.parse_string("import genrec_tpu.models.cobra")
configlib.parse_string("import genrec_tpu.trainers.stream_trainer")
assert "genrec_tpu_torch.trainers.stream_trainer" in sys.modules
try:
    configlib.parse_string("import genrec_tpu.fleet.router")
except ImportError as e:
    assert "ROADMAP A26" in str(e), e
else:
    raise AssertionError("the unported fleet router imported")
leaked = sorted(
    n for n, m in sys.modules.items()
    if m is not None and n.split(".")[0] in FORBIDDEN
)
assert not leaked, leaked
print("ok")
"""


def test_gin_import_of_an_unported_module_names_its_roadmap_item():
    """``import genrec_tpu.trainers.{tiger,cobra,notellm,stream}_trainer`` in
    a gin file resolves to the port's modules; a module the port lacks
    (``fleet.router``) raises naming its ROADMAP item; neither jax nor
    genrec_tpu enters sys.modules (a fresh interpreter)."""
    proc = subprocess.run([sys.executable, "-c", _GIN_IMPORTS], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and proc.stdout.split()[-1] == "ok", proc.stderr


@pytest.mark.parametrize("gin", ["config/sasrec/synthetic.gin", "config/sasrec/amazon.gin"])
def test_sasrec_gin_files_parse_for_the_port(gin):
    """SASRec is ported: its modules import by their JAX names and both
    config files bind the port's trainer unchanged."""
    from genrec_tpu_torch import configlib
    from genrec_tpu_torch.configlib import registry
    from genrec_tpu_torch.trainers import sasrec_trainer

    configlib.clear_bindings()
    configlib.clear_macros()
    try:
        configlib.parse_string("import genrec_tpu.models.sasrec\n"
                               "import genrec_tpu.trainers.sasrec_trainer")
        configlib.parse_file(gin, substitutions={"split": "beauty"})
        b = configlib.get_bindings("genrec_tpu_torch.trainers.sasrec_trainer.train")
        assert registry.lookup("genrec_tpu.trainers.sasrec_trainer.train") is sasrec_trainer.train
    finally:
        configlib.clear_bindings()
        configlib.clear_macros()
    assert b["num_heads"] == 2 and b["embed_dim"] in (32, 64)


def test_every_module_imports_without_jax_or_the_jax_package():
    proc = subprocess.run(
        [sys.executable, "-c", _IMPORT_EVERY_MODULE], cwd=REPO,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    # Every module of the slice was reached (models, ops, kernels, catalog,
    # serving and their packages), the speculative tree's among them.
    assert int(proc.stdout.split()[-1]) >= 20


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize(
    "path",
    [REPO / "chip_smoke.py"] + sorted((REPO / "genrec_tpu_torch").rglob("*.py")),
    ids=lambda p: str(p.relative_to(REPO)),
)
def test_source_names_no_forbidden_import(path):
    assert not _imported_roots(path) & set(FORBIDDEN)


@pytest.fixture
def no_card(monkeypatch):
    """Entry points behave as on a machine without a CUDA device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_entry_points_raise_without_a_card(no_card):
    cfg = dict(embedding_dim=8, attn_dim=16, num_heads=2, n_layers=2,
               num_item_embeddings=4, num_user_embeddings=3, sem_id_dim=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Tiger(**cfg)
    for build in (
        lambda: RMSNorm(8),
        lambda: SemIdEmbedding(4, 2, 8),
        lambda: UserIdEmbedding(3, 8),
        lambda: T5Attention(16, 2),
        lambda: T5FeedForward(16, 32),
        lambda: TransformerBlock(16, 2, 32, cross_attn=True),
        lambda: TransformerEncoder(16, 1, 2, 32),
        lambda: TransformerDecoder(16, 1, 2, 32),
        lambda: TransformerEncoderDecoder(16, 2, 1, 1, 32),
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        KVPagePool(PagedConfig(max_slots=2, page_size=8, pages_per_slot=1), 1, 2, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        KVPagePool(PagedConfig(max_slots=2, page_size=8, pages_per_slot=1, kv_dtype="int8"),
                   1, 2, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RqVae(input_dim=8, embed_dim=4, hidden_dims=(6,), codebook_size=4)
    from genrec_tpu_torch.trainers import lcrec_trainer, rqvae_trainer

    with pytest.raises(RuntimeError, match="no CUDA device"):
        rqvae_trainer.train(epochs=1, save_dir_root=None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lcrec_trainer.train(epochs=1, save_dir_root=None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        notellm_trainer.train(epochs=1, save_dir_root=None)
    from genrec_tpu_torch.models.backbones.qwen import QwenConfig, QwenLM

    with pytest.raises(RuntimeError, match="no CUDA device"):
        QwenLM(QwenConfig(vocab_size=16, hidden_size=8, intermediate_size=8,
                          num_hidden_layers=1, num_attention_heads=2, num_key_value_heads=2))
    catalog = CatalogSnapshot.build(np.asarray([[0, 1], [2, 3]]), 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        catalog.device_trie()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TensorTrie.build(np.asarray([[0, 1]]), 4).to()
    head = TigerGenerativeHead(Tiger(device="cpu", **cfg), catalog=catalog)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine([head])
    sasrec = dict(num_items=10, max_seq_len=4, embed_dim=8, num_heads=2, num_blocks=1,
                  ffn_dim=16)
    for build in (lambda: SASRec(**sasrec), lambda: SASRecBlock(8, 2, 16, 0.0)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()
    retrieval = RetrievalHead("sasrec", SASRec(**sasrec, device="cpu"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine([retrieval, head])
    from genrec_tpu_torch.trainers import sasrec_trainer

    with pytest.raises(RuntimeError, match="no CUDA device"):
        sasrec_trainer.train(epochs=1, save_dir_root=None)
    cobra = dict(encoder_hidden_dim=8, encoder_num_heads=2, encoder_vocab_size=20,
                 id_vocab_size=4, n_codebooks=2, d_model=8, max_len=16,
                 decoder_n_layers=1, decoder_num_heads=2)
    for build in (lambda: Cobra(**cobra), lambda: LightT5Encoder(1, 8, 8, 2, vocab_size=20),
                  lambda: CobraDecoder(8, 1, 2), lambda: CobraEmbedding(4, 2, 8, 16)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()
    cobra_model = Cobra(**cobra, device="cpu")
    assert init_cobra_paged_state(cobra_model, 2, 3)["cache_k"].device.type == "cpu"
    cobra_head = CobraGenerativeHead(cobra_model, catalog=CatalogSnapshot.build(
        np.asarray([[0, 1], [2, 3]]), 4, item_text_tokens=np.ones((2, 3), np.int64)))
    assert cobra_head.tower_encodes == 1
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine([cobra_head])
    assert ServingEngine([cobra_head, head], device="cpu").device == torch.device("cpu")
    # Asked for explicitly, the CPU serves; the speculative engine too, and
    # its scratch pages and the prefix index live on the pool it builds.
    assert ServingEngine([head], device="cpu").device == torch.device("cpu")
    spec = ServingEngine([head], device="cpu", spec_decode=True).start()
    runner = spec.runner(head.name)
    assert runner.pool.k_pools[0].device.type == "cpu"
    assert runner.spec_topology.n_nodes == TreeTopology(head.top_k, 8, 1).n_nodes
    assert isinstance(runner.prefix, PrefixIndex) and runner.pool.scratch_page_count > 0
    spec.stop()
    assert runner.pool.scratch_page_count == 0
    assert tree_topology(2, 3, 1).on("cpu")["anc"].device.type == "cpu"
    assert ServingEngine([retrieval, head], device="cpu").device == torch.device("cpu")


def _run_smoke(cwd: Path) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, capture_output=True,
        text=True, timeout=300,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""},
    )


def test_chip_smoke_fails_without_a_card_and_alone(tmp_path):
    """No card: a non-zero exit and no result line. Copied into a
    directory that holds nothing else of the repo: the same."""
    alone = tmp_path / "alone"
    alone.mkdir()
    shutil.copy(REPO / "chip_smoke.py", alone / "chip_smoke.py")
    for cwd in (REPO, alone):
        proc = _run_smoke(cwd)
        assert proc.returncode != 0, proc.stdout
        assert '"ok"' not in proc.stdout
