"""The port's text path against the JAX package: MSDP (tasks/msdp.py,
tasks/msdp_preprocess.py) byte for byte on the same files, greedy text
through inference/api.generate_and_post_process with a GPT-2 BPE
vocabulary the test learns, and the port's server answering text over
HTTP with that vocabulary (the server's tokenizer flags, the REST client
and MSDP's --megatron_api_url mode)."""

import _torch_threads  # noqa: F401  (first: one torch thread)

import builtins
import json
import threading

import jax
import numpy as np
import pytest

from megatron_tpu.inference.api import (
    generate_and_post_process as j_generate,
)
from megatron_tpu.models import presets as j_presets
from megatron_tpu.models.params import init_params as j_init_params
from megatron_tpu.tokenizer import build_tokenizer as j_build_tokenizer
from megatron_tpu_torch.inference.api import generate_and_post_process
from megatron_tpu_torch.inference.server import run_server
from megatron_tpu_torch.models import presets
from megatron_tpu_torch.models.params import params_from_numpy
from megatron_tpu_torch.tasks import msdp, msdp_preprocess
from megatron_tpu_torch.tokenizer import build_tokenizer
from megatron_tpu_torch.tokenizer.gpt2_bpe import train_vocab, write_vocab
from megatron_tpu_torch.tools import run_text_generation_server as server_tool
from megatron_tpu_torch.tools import text_generation_cli
from tasks import msdp as j_msdp
from tasks import msdp_preprocess as j_pre

SEED = 21
WORDS = ("the river city music band early played blues jazz people "
         "guitar piano history famous style new orleans record songs "
         "radio dance club night street first known many years later "
         "players south north west east modern classic sound").split()


def _sentence(rng, n):
    return " ".join(WORDS[i] for i in rng.integers(0, len(WORDS), n))


def write_wow(path, n=16, seed=SEED):
    """n Wizard-of-Wikipedia dialogues from a seed: each wizard turn
    copies 12 of its checked sentence's 14 words (so it passes the
    response-prompt overlap filter), every third one has no knowledge."""
    rng = np.random.default_rng(seed)
    data = []
    for d in range(n):
        topic = f"Topic {WORDS[d % 7]}"
        dialog, k = [], 0
        for t in range(6):
            if t % 2 == 0:
                dialog.append({"speaker": "0_Apprentice",
                               "text": _sentence(rng, 6) + "?"})
                continue
            k += 1
            if k % 3 == 0:
                dialog.append({"speaker": "1_Wizard",
                               "text": _sentence(rng, 8),
                               "checked_sentence": {},
                               "checked_passage": {}})
                continue
            know = _sentence(rng, 14)
            words = know.split()
            dialog.append({
                "speaker": "1_Wizard",
                "text": " ".join(words[:12]) + " " + _sentence(rng, 3) + ".",
                "checked_sentence": {"s": know + "."},
                "checked_passage": {"p": topic}})
        data.append({"chosen_topic": topic, "dialog": dialog})
    path.write_text(json.dumps(data))


def write_woi(path, n=6, seed=SEED):
    rng = np.random.default_rng(seed + 1)
    with open(path, "w") as f:
        for d in range(n):
            hist = [{"action": "Wizard => Apprentice",
                     "text": _sentence(rng, 5)},
                    {"action": "Wizard => SearchAgent",
                     "text": f"search {WORDS[d]}"},
                    {"action": "Apprentice => Wizard",
                     "text": _sentence(rng, 6)}]
            for r in range(2):
                sel = [[r == 1], [False, True]]
                hist.append({
                    "action": "Wizard => Apprentice",
                    "text": _sentence(rng, 9),
                    "context": {"contents": [{"content": [
                        _sentence(rng, 7), _sentence(rng, 8)]}],
                        "selected_contents": sel}})
            f.write(json.dumps({f"d{d}": {"dialog_history": hist}}) + "\n")


def _run_both(tmp_path, fn_name, make_args, outputs):
    """fn_name of both packages on the same inputs, each writing its own
    output files; returns the two sets of bytes."""
    got = {}
    for tag, mod in (("jax", j_pre), ("port", msdp_preprocess)):
        out = {k: str(tmp_path / f"{tag}_{k}") for k in outputs}
        ret = getattr(mod, fn_name)(*make_args(out))
        got[tag] = (ret, {k: open(v, "rb").read() for k, v in out.items()})
    return got["jax"], got["port"]


def test_preprocess_byte_equal_to_jax(tmp_path):
    raw, woi = tmp_path / "wow.json", tmp_path / "woi.jsonl"
    write_wow(raw)
    write_woi(woi)
    j, t = _run_both(tmp_path, "process_wow_dataset",
                     lambda o: (str(raw), o["tsv"], o["knwl"], o["resp"]),
                     ("tsv", "knwl", "resp"))
    assert j == t and j[0] > 16
    tsv = tmp_path / "jax_tsv"
    j2, t2 = _run_both(tmp_path, "process_woi_dataset",
                       lambda o: (str(woi), o["w"], o["k"], o["r"]),
                       ("w", "k", "r"))
    assert j2 == t2 and j2[0] > 0
    rows = tsv.read_text().splitlines()
    test = tmp_path / "test.tsv"
    test.write_text("\n".join(rows[: len(rows) // 2]) + "\n")
    for data_type in ("wow_seen", "wow_unseen"):
        j3, t3 = _run_both(
            tmp_path, "prompt_selection_for_knowledge_generation",
            lambda o: (str(test), str(tsv), o["p"], data_type), ("p",))
        assert j3 == t3 and j3[0] == len(rows) // 2
    j4, t4 = _run_both(tmp_path, "prompt_selection_for_response_generation",
                       lambda o: (str(tsv), o["p"], 1234), ("p",))
    assert j4 == t4 and j4[0] > 0
    knwl = tmp_path / "knwl_gen.txt"
    knwl.write_text("".join(f"generated {i}<|endoftext|>\n"
                            for i in range(len(rows))))
    j5, t5 = _run_both(tmp_path, "prepare_input_for_response_generation",
                       lambda o: (str(tsv), str(knwl), o["p"]), ("p",))
    assert j5 == t5
    texts = ["Hello, World! it's the (new) jazz", "a an the"]
    assert np.array_equal(j_pre.hash_embed(texts),
                          msdp_preprocess.hash_embed(texts))


def test_preprocess_main_writes_what_the_functions_write(tmp_path):
    raw = tmp_path / "wow.json"
    write_wow(raw)
    out = tmp_path / "main.tsv"
    n = msdp_preprocess.main(["--func", "process_wow_dataset", "--raw_file",
                              str(raw), "--processed_file", str(out)])
    fn = tmp_path / "fn.tsv"
    assert n == msdp_preprocess.process_wow_dataset(str(raw), str(fn))
    assert out.read_bytes() == fn.read_bytes()


def test_prompting_and_f1_equal_jax(tmp_path):
    raw, tsv = tmp_path / "wow.json", tmp_path / "t.tsv"
    write_wow(raw)
    msdp_preprocess.process_wow_dataset(str(raw), str(tsv))
    kp, rp = tmp_path / "k.jsonl", tmp_path / "r.txt"
    msdp_preprocess.prompt_selection_for_knowledge_generation(
        str(tsv), str(tsv), str(kp), "wow_seen")
    msdp_preprocess.prompt_selection_for_response_generation(str(tsv),
                                                             str(rp))
    echo = lambda p: p + " the river city\nsecond line"  # noqa: E731
    for kind, prompt in (("knowledge", kp), ("response", rp)):
        outs = []
        for tag, mod in (("jax", j_msdp), ("port", msdp)):
            out = tmp_path / f"{tag}_{kind}.txt"
            n = mod.generate_file(str(tsv), str(out), kind, str(prompt),
                                  echo, 3)
            outs.append((n, out.read_bytes()))
        assert outs[0] == outs[1]
        assert outs[0][1].startswith(b"the river city\n")
    guess = tmp_path / "jax_response.txt"
    gold = tmp_path / "gold.txt"
    gold.write_text("the river city\nno_passages_used\n"
                    + "jazz\n" * (outs[0][0] - 2))
    assert (msdp.evaluate_f1(str(guess), str(gold))
            == j_msdp.evaluate_f1(str(guess), str(gold)))
    for g, a in (("The cat, sat!", "a cat sat"), ("", "x"), ("x", "")):
        assert msdp.token_f1(g, a) == j_msdp.token_f1(g, a)


# -- a BPE vocabulary, greedy text and the server ---------------------------


@pytest.fixture(scope="module")
def bpe(tmp_path_factory):
    d = tmp_path_factory.mktemp("bpe")
    rng = np.random.default_rng(SEED)
    texts = [_sentence(rng, 30) + "." for _ in range(40)]
    vocab, merges = train_vocab(texts, 60)
    vf, mf = str(d / "vocab.json"), str(d / "merges.txt")
    write_vocab(vocab, merges, vf, mf)
    return vf, mf, len(vocab)


@pytest.fixture(scope="module")
def model(bpe):
    kw = dict(vocab_size=384, seq_length=512)
    jcfg, tcfg = j_presets.tiny(**kw), presets.tiny(**kw)
    jparams = j_init_params(jcfg, jax.random.PRNGKey(SEED))
    tparams = params_from_numpy(jax.device_get(jparams), tcfg, device="cpu")
    return jcfg, jparams, tcfg, tparams


PROMPTS = ["the river city music", "jazz people played the blues"]


def test_greedy_text_equals_jax(bpe, model):
    vf, mf, n_vocab = bpe
    jcfg, jparams, tcfg, tparams = model
    jtok = j_build_tokenizer("GPT2BPETokenizer", vocab_file=vf,
                             merges_file=mf)
    ttok = build_tokenizer("GPT2BPETokenizer", vocab_file=vf,
                           merges_file=mf)
    assert jtok.vocab_size == ttok.vocab_size == n_vocab
    jt, _, _, jtoks = j_generate(jcfg, jparams, jtok, PROMPTS,
                                 tokens_to_generate=8, top_k_sampling=1)
    tt, _, _, ttoks = generate_and_post_process(
        tcfg, tparams, ttok, PROMPTS, tokens_to_generate=8,
        top_k_sampling=1)
    assert tt == jt
    assert (np.asarray(ttoks) < n_vocab).all()


def test_text_server_cli_and_msdp_api_mode(bpe, model, tmp_path,
                                           monkeypatch, capsys):
    vf, mf, n_vocab = bpe
    _, _, tcfg, tparams = model
    args = server_tool.parse_args([
        "--tokenizer_type", "GPT2BPETokenizer", "--vocab_file", vf,
        "--merges_file", mf, "--device", "cpu"])
    tok = server_tool.server_tokenizer(args, tcfg.vocab_size)
    assert tok.vocab_size == n_vocab
    ready, out = threading.Event(), []
    t = threading.Thread(
        target=run_server, daemon=True,
        kwargs=dict(cfg=tcfg, params=tparams, tokenizer=tok,
                    host="127.0.0.1", port=0, engine_slots=2,
                    engine_max_seq_len=512, device="cpu", ready=ready,
                    service_out=out))
    t.start()
    assert ready.wait(60)
    _, server = out
    address = f"127.0.0.1:{server.server_address[1]}"
    url = f"http://{address}/api"
    try:
        direct = generate_and_post_process(
            tcfg, tparams, tok, PROMPTS[:1], tokens_to_generate=6,
            top_k_sampling=1)[0][0]
        text = msdp._api_generate_fn(url, 6)(PROMPTS[0])
        assert text == direct and text.startswith(PROMPTS[0])
        assert text_generation_cli.generate(url, PROMPTS[1], 4).startswith(
            PROMPTS[1])
        lines = iter([PROMPTS[0], ""])

        def fake_input(_prompt=""):
            try:
                return next(lines)
            except StopIteration:
                raise EOFError from None

        monkeypatch.setattr(builtins, "input", fake_input)
        assert text_generation_cli.main([address,
                                         "--tokens_to_generate", "4"]) == 0
        printed = capsys.readouterr().out
        assert printed.count("Megatron-TPU: " + PROMPTS[0]) == 1
        # MSDP's prompt-response through the server, then eval-f1
        raw, tsv = tmp_path / "wow.json", tmp_path / "t.tsv"
        write_wow(raw, n=2)
        msdp_preprocess.process_wow_dataset(str(raw), str(tsv))
        rp = tmp_path / "r.txt"
        msdp_preprocess.prompt_selection_for_response_generation(str(tsv),
                                                                 str(rp))
        short = tmp_path / "short.tsv"
        short.write_text("".join(tsv.read_text().splitlines(True)[:2]))
        resp = tmp_path / "resp.txt"
        msdp.main(["prompt-response", "--prompt_file", str(rp),
                   "--sample_input_file", str(short),
                   "--sample_output_file", str(resp),
                   "--num_prompt_examples", "1", "--out_seq_length", "4",
                   "--megatron_api_url", url])
        assert len(resp.read_text().splitlines()) == 2
        msdp.main(["eval-f1", "--guess_file", str(resp), "--answer_file",
                   str(resp)])
        assert "f1: " in capsys.readouterr().out
    finally:
        server.shutdown()
        t.join(30)


def test_local_prompt_knowledge_equals_the_api_path(tmp_path):
    """msdp prompt-knowledge on the local model (--device cpu, weights
    from --seed): each output line is generate_and_post_process's greedy
    continuation of the line's prompt on the same weights. A byte-level
    vocabulary (no merges) keeps every prompt id inside the tiny
    preset's 256-row table."""
    from megatron_tpu_torch.models.params import init_params

    rng = np.random.default_rng(SEED)
    vocab, merges = train_vocab([_sentence(rng, 20)], 0)
    vf, mf = str(tmp_path / "v.json"), str(tmp_path / "m.txt")
    write_vocab(vocab, merges, vf, mf)
    raw, tsv = tmp_path / "wow.json", tmp_path / "t.tsv"
    write_wow(raw, n=2)
    msdp_preprocess.process_wow_dataset(str(raw), str(tsv))
    short = tmp_path / "short.tsv"
    short.write_text("".join(tsv.read_text().splitlines(True)[:2]))
    kp = tmp_path / "k.jsonl"
    msdp_preprocess.prompt_selection_for_knowledge_generation(
        str(short), str(tsv), str(kp), "wow_seen", num_prompts=1)
    out = tmp_path / "knwl.txt"
    msdp.main(["prompt-knowledge", "--model_name", "tiny", "--seq_length",
               "1024", "--tokenizer_type", "GPT2BPETokenizer",
               "--vocab_file", vf, "--merges_file", mf, "--prompt_file",
               str(kp), "--sample_input_file", str(short),
               "--sample_output_file", str(out), "--out_seq_length", "4",
               "--seed", "3", "--device", "cpu"])
    cfg = presets.tiny(seq_length=1024)
    params = init_params(cfg, 3, device="cpu")
    tok = build_tokenizer("GPT2BPETokenizer", vocab_file=vf, merges_file=mf)

    def gen(prompt):
        return generate_and_post_process(cfg, params, tok, [prompt],
                                         tokens_to_generate=4,
                                         top_k_sampling=1)[0][0]

    want = tmp_path / "want.txt"
    msdp.generate_file(str(short), str(want), "knowledge", str(kp), gen)
    assert out.read_bytes() == want.read_bytes()
    assert len(out.read_text().splitlines()) == 2
