"""LCRec SFT task factory + tokenizers (word-level fallback and HF adapter)
(copy of genrec_tpu/data/lcrec_tasks.py; numpy only, ``transformers``
only through a tokenizer the caller passes).

Parity target: reference genrec/data/amazon_lcrec.py — six SFT task
families (seqrec, item2index, index2item, fusionseqrec, itemsearch,
preferenceobtain; :5-12), prompt-template pools at the reference's scale
(17 seqrec templates, per-subtype item2index/index2item pools, 12
fusionseqrec, 11 itemsearch, 12 preferenceobtain; :42-161), task sampling
weights (:214-221), sem-id -> ``<Cc_k>`` token rendering (:456-475),
numbered ", "-separated history rendering (:462-475), itemsearch query
simulation from the target's category/title (:560-576), preference text
from history categories (:585-600), and an Alpaca-style
instruction/response frame (:29-33). All template TEXT here is original
wording (behavioral role preserved; reference phrasing not copied).

Tokenizers: the `WordTokenizer` is a dependency-free stand-in for the HF
tokenizer in zero-egress environments; `HFTokenizerAdapter` wraps a real
``transformers`` tokenizer, appending one single-id special token per
``<Cc_k>`` — the property the constrained decoder relies on
(ConstrainedDecodingHelper admits only codebook tokens that tokenize to a
single id, lcrec_trainer.py:100-104) — and verifying the ids form the
contiguous tail range the jitted cascade slices.
"""

from __future__ import annotations

import re

import numpy as np

RESPONSE_MARKER = "### Response:"
HISTORY_SEP = ", "

# ---------------------------------------------------------------------------
# Prompt template pools (reference-scale; original wording).
# ---------------------------------------------------------------------------

_SEQREC_TEMPLATES = [
    "Items viewed so far, in order: {history}\nGive the index of the next item.",
    "This shopper's sequence is {history}. Which index follows?",
    "Chronological interactions: {history}\nEmit the next item's index tokens.",
    "After engaging with {history}, the user will pick:",
    "Sequence: {history}\nContinue it with one more item index.",
    "Knowing the ordered history {history}, name the upcoming item's index.",
    "The trail of purchases reads {history}. Predict what comes after.",
    "From the log {history}, infer the following item's index.",
    "Consumption record: {history}\nForecast the next index.",
    "A customer went through {history} — what index is next on their list?",
    "Ordered item indices: {history}\nAppend the most likely continuation.",
    "Given {history} as the browsing path, output the succeeding index.",
    "So far the account shows {history}. Next index?",
    "Complete the sequence {history} with the index of the next engagement.",
    "Reading the timeline {history}, decide which item follows.",
    "With {history} already consumed, recommend the next item's index.",
    "History of indices: {history}\nYour prediction for the next one:",
]

_ITEM2INDEX_TEMPLATES = {
    "title": [
        "Title: {title}\nCorresponding index:",
        'Which index belongs to the product called "{title}"?',
        'Translate the title "{title}" into index tokens.',
        "The product named {title} is indexed as:",
        "Provide the index registered for the title {title}.",
        'Resolve "{title}" to its item index.',
    ],
    "desc": [
        "Description: {description}\nCorresponding index:",
        'An item described by "{description}" carries the index:',
        "Turn this description into index tokens: {description}",
        "Which index matches the following details? {description}",
        "From the description {description}, derive the item index.",
        'The catalogue entry "{description}" resolves to index:',
    ],
    "combined": [
        "Product {title}, details: {description}\nIndex:",
        'Given the name "{title}" and the description "{description}", state the index.',
        "{title} — {description}\nWhat is this item's index?",
        "Identify the index of the product titled {title} whose details read {description}.",
        "Name: {title}\nDetails: {description}\nIndex tokens:",
        'Combine title "{title}" and description "{description}" to produce the index.',
        "For the listing {title} ({description}), emit the index.",
    ],
}

_INDEX2ITEM_TEMPLATES = {
    "title": [
        "Index: {index}\nTitle of this item:",
        "Which product title sits at index {index}?",
        "Recover the title encoded by {index}.",
        "The index {index} names the item:",
        "State the title registered under {index}.",
        "Decode {index} into the product's title.",
    ],
    "desc": [
        "Index: {index}\nDescription of this item:",
        "Write out the details of the item at {index}.",
        "What description corresponds to index {index}?",
        "The tokens {index} stand for an item described as:",
        "Expand index {index} into its catalogue description.",
        "Give the descriptive text stored for {index}.",
    ],
    "combined": [
        "Index: {index}\nTitle and description:",
        "Report both the title and the details of the item encoded {index}.",
        "Unpack {index}: provide its name followed by its description.",
        "For index {index}, list the product name and its features.",
        "The entry at {index} is titled and described as:",
    ],
}

_FUSIONSEQREC_TEMPLATES = [
    "Ordered history: {history}\nPredict the next item's index together with its title.",
    "After {history}, which item follows? Answer with index and name.",
    "Sequence so far: {history}\nNext item, giving both tokens and title:",
    "From {history}, forecast the coming item's identifier plus its name.",
    "Trail: {history}\nContinue with the next index and what it is called.",
    "The shopper's log reads {history}. Supply the next item's index and label.",
    "Given {history}, respond with the following item's index-name pair.",
    "Consumption path {history} -> next item (tokens, then title):",
    "Looking at {history}, produce the upcoming item's code and title.",
    "History: {history}\nYour joint prediction of index and product name:",
    "With {history} behind them, the user's next item (index + title) is:",
    "Extend the sequence {history}; include the new item's index and its name.",
]

_ITEMSEARCH_TEMPLATES = [
    "Request: {query}\nPast items: {history}\nIndex of the matching product:",
    'The user types "{query}". Their record shows {history}. Best index:',
    "Search phrase {query}, context {history} — return the fitting item's index.",
    'Match the need "{query}" against history {history} and give an index.',
    "Wanted: {query}\nBackground: {history}\nAnswer with index tokens.",
    "Considering {history}, which index satisfies the query {query}?",
    "Shopping goal: {query}\nPrior activity: {history}\nChosen index:",
    'Resolve the request "{query}" (history {history}) to a single item index.',
    "With interests shaped by {history}, the query {query} leads to index:",
    "Customer asks for {query}; they previously chose {history}. Recommend by index.",
    'Find an item for "{query}" personalised via {history}. Index:',
]

_PREFERENCE_TEMPLATES = [
    "Given the ordered items {history}, characterise this user's tastes.",
    "What does the record {history} reveal about the user's preferences?",
    "Summarise the interests implied by {history}.",
    "From {history}, write a short profile of what the user enjoys.",
    "The log {history} suggests the user tends to like:",
    "Derive the shopper's preferences from {history}.",
    "Looking over {history}, describe their buying inclinations.",
    "Items {history} point to which interests?",
    "Sketch the user's taste based on the sequence {history}.",
    "Interpret {history} as evidence of the user's preferred products.",
    "Having seen {history}, state what this customer gravitates toward.",
    "Preferences inferred from {history}:",
]

TASKS = ("seqrec", "item2index", "index2item", "fusionseqrec", "itemsearch", "preferenceobtain")
# Reference task sampling weights (amazon_lcrec.py:214-221 shape: seqrec-heavy).
DEFAULT_TASK_WEIGHTS = (0.5, 0.15, 0.1, 0.1, 0.1, 0.05)
_SUBTYPES = ("title", "desc", "combined")


def render_sem_id(sem_id) -> str:
    """(c0, c1, ...) -> "<C0_5><C1_2>..." (amazon_lcrec.py:456-475)."""
    return "".join(f"<C{c}_{int(k)}>" for c, k in enumerate(sem_id))


def alpaca_frame(instruction: str, response: str = "") -> tuple[str, str]:
    prompt = (
        "Below is an instruction that describes a task. Write a response "
        "that appropriately completes the request.\n\n### Instruction:\n"
        f"{instruction}\n\n{RESPONSE_MARKER}\n"
    )
    return prompt, response


def _template_words() -> set[str]:
    """Whitespace tokens of every template/frame with slots blanked — the
    word inventory the WordTokenizer needs to avoid mass-unk prompts."""
    pools = [
        _SEQREC_TEMPLATES,
        *_ITEM2INDEX_TEMPLATES.values(),
        *_INDEX2ITEM_TEMPLATES.values(),
        _FUSIONSEQREC_TEMPLATES,
        _ITEMSEARCH_TEMPLATES,
        _PREFERENCE_TEMPLATES,
    ]
    words: set[str] = set()
    blank = {"history": "", "title": "", "description": "", "index": "", "query": ""}
    for pool in pools:
        for tmpl in pool:
            words.update(tmpl.format(**blank).split())
    frame_p, _ = alpaca_frame("")
    words.update(frame_p.split())
    words.update(
        "the user prefers and is interested in: The a item_".split()
    )
    # Numbered-history prefixes render as standalone "k." tokens.
    words.update(f"{i}." for i in range(1, 51))
    return words


class WordTokenizer:
    """Word-level tokenizer with single-id special tokens.

    ids: 0 = pad, 1 = eos, 2 = unk, then words, then codebook specials
    appended LAST so they form the contiguous tail ranges the constrained
    decoder slices.
    """

    def __init__(self, words: list[str], num_codebooks: int, codebook_size: int):
        self.pad_id, self.eos_id, self.unk_id = 0, 1, 2
        self.word_to_id = {w: i + 3 for i, w in enumerate(words)}
        self.base_vocab = 3 + len(words)
        self.num_codebooks = num_codebooks
        self.codebook_size = codebook_size
        self.special = {
            f"<C{c}_{k}>": self.base_vocab + c * codebook_size + k
            for c in range(num_codebooks)
            for k in range(codebook_size)
        }
        self.vocab_size = self.base_vocab + num_codebooks * codebook_size
        self._id_to_word = {i: w for w, i in self.word_to_id.items()}
        self._id_to_word.update({i: t for t, i in self.special.items()})

    def encode(self, text: str) -> list[int]:
        out = []
        for piece in re.split(r"(<C\d+_\d+>)", text):
            if not piece:
                continue
            if piece in self.special:
                out.append(self.special[piece])
            else:
                for w in piece.split():
                    out.append(self.word_to_id.get(w, self.unk_id))
        return out

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        words = []
        for i in ids:
            i = int(i)
            if i in (self.pad_id, self.eos_id, self.unk_id):
                continue
            if skip_special_tokens and i >= self.base_vocab:
                continue
            w = self._id_to_word.get(i)
            if w is not None:
                words.append(w)
        return " ".join(words)


class HFTokenizerAdapter:
    """Wrap a HuggingFace tokenizer behind the WordTokenizer interface.

    Adds one special token per ``<Cc_k>`` in (c, k) order and verifies they
    land on a CONTIGUOUS id range (they do: HF assigns added-token ids
    sequentially from len(tokenizer)); ``base_vocab`` is the first codebook
    token id, which the jitted constrained decoder uses as its slice base.
    Note base_vocab may differ from the MODEL's padded vocab size — the
    trainer passes it to extend_vocab explicitly.
    """

    def __init__(self, tokenizer, num_codebooks: int, codebook_size: int):
        self.tok = tokenizer
        self.num_codebooks = num_codebooks
        self.codebook_size = codebook_size
        specials = [
            f"<C{c}_{k}>"
            for c in range(num_codebooks)
            for k in range(codebook_size)
        ]
        tokenizer.add_tokens(specials, special_tokens=True)
        ids = tokenizer.convert_tokens_to_ids(specials)
        if ids != list(range(ids[0], ids[0] + len(specials))):
            raise ValueError(
                "codebook special tokens did not get contiguous ids; the "
                "constrained decoder requires the <Cc_k> tail ranges"
            )
        for t, i in zip(specials, ids):
            got = tokenizer(t, add_special_tokens=False)["input_ids"]
            if got != [i]:
                raise ValueError(f"{t} does not tokenize to a single id: {got}")
        self.base_vocab = ids[0]
        self.eos_id = tokenizer.eos_token_id
        if self.eos_id is None:
            raise ValueError("HF tokenizer must define an eos token")
        self.pad_id = (
            tokenizer.pad_token_id if tokenizer.pad_token_id is not None else self.eos_id
        )
        self.vocab_size = self.base_vocab + len(specials)

    def encode(self, text: str) -> list[int]:
        return self.tok(text, add_special_tokens=False)["input_ids"]

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        ids = [int(i) for i in ids if int(i) != self.pad_id]
        return self.tok.decode(ids, skip_special_tokens=skip_special_tokens)


class LCRecTaskData:
    """Build SFT samples over sequences + sem-ids + item texts.

    ``item_titles`` / ``item_categories`` unlock the reference's subtype
    templates (title/desc/combined) and category-driven itemsearch /
    preferenceobtain; without them, tasks fall back to the flat
    ``item_texts`` behavior (synthetic path)."""

    def __init__(
        self,
        sequences: list[np.ndarray],
        sem_ids: np.ndarray,
        item_texts: list[str],
        tokenizer,
        max_len: int = 96,
        max_history: int = 8,
        task_weights=DEFAULT_TASK_WEIGHTS,
        seed: int = 0,
        item_titles: list[str] | None = None,
        item_categories: list[str] | None = None,
        numbered_history: bool = False,
    ):
        self.sequences = sequences
        self.sem_ids = np.asarray(sem_ids)
        self.item_texts = item_texts
        self.item_titles = item_titles
        self.item_categories = item_categories
        self.numbered_history = numbered_history
        self.tok = tokenizer
        self.max_len = max_len
        self.max_history = max_history
        self.task_weights = np.asarray(task_weights) / np.sum(task_weights)
        self.rng = np.random.default_rng(seed)

    # ---- text assembly ----------------------------------------------------

    def _index(self, item: int) -> str:
        return render_sem_id(self.sem_ids[item - 1])

    def _title(self, item: int) -> str:
        if self.item_titles is not None:
            return self.item_titles[item - 1]
        return self.item_texts[item - 1]

    def _description(self, item: int) -> str:
        """Reference derivation (amazon_lcrec.py:497-500): full text minus
        the title, stripped; title again when that leaves nothing."""
        text, title = self.item_texts[item - 1], self._title(item)
        return text.replace(title, "").strip(" -()") or title

    def _history_str(self, items) -> str:
        tail = items[-self.max_history :]
        if self.numbered_history:
            # "1. <C0_3><C1_7>, 2. ..." (amazon_lcrec.py:462-475).
            return HISTORY_SEP.join(
                f"{n + 1}. {self._index(i)}" for n, i in enumerate(tail)
            )
        return HISTORY_SEP.join(self._index(i) for i in tail)

    def _pick(self, pool):
        return pool[self.rng.integers(len(pool))]

    def _subtype_instruction(self, pools: dict, item: int) -> str:
        if self.item_titles is None:
            # Flat-text fallback: desc == text, so use the desc pool.
            return self._pick(pools["desc"]).format(
                description=self.item_texts[item - 1],
                index=self._index(item),
            )
        subtype = _SUBTYPES[self.rng.integers(len(_SUBTYPES))]
        return self._pick(pools[subtype]).format(
            title=self._title(item),
            description=self._description(item),
            index=self._index(item),
        )

    def _search_query(self, item: int) -> str:
        """Simulated query: the category half the time (when known), else
        up to three sampled title words (amazon_lcrec.py:560-576)."""
        cat = (
            self.item_categories[item - 1]
            if self.item_categories is not None
            else ""
        )
        title = self._title(item)
        if cat and self.rng.random() < 0.5:
            return cat
        words = title.split()
        if len(words) > 2:
            pick = self.rng.choice(len(words), size=3, replace=False)
            return " ".join(words[j] for j in sorted(pick))
        return title or "similar item"

    def _preference_text(self, items) -> str:
        """Response from history categories when available
        (amazon_lcrec.py:585-600); liked-item phrasing otherwise."""
        if self.item_categories is not None:
            cats = []
            for i in items:
                c = self.item_categories[i - 1].split(",")[0].strip()
                if c and c not in cats:
                    cats.append(c)
            if cats:
                return "The user is interested in: " + ", ".join(cats[:5])
        liked = " and ".join(self._title(i) for i in items[-3:])
        return f"the user prefers {liked}"

    # ---- task sampling ----------------------------------------------------

    def _sample_for(self, task: str, seq: np.ndarray):
        r = self.rng
        body = seq[:-2]
        if task == "seqrec" and len(body) >= 2:
            t = r.integers(1, len(body))
            tmpl = self._pick(_SEQREC_TEMPLATES)
            return tmpl.format(history=self._history_str(body[:t])), self._index(body[t])
        item = int(seq[r.integers(len(body))]) if len(body) else int(seq[0])
        if task == "item2index":
            return (
                self._subtype_instruction(_ITEM2INDEX_TEMPLATES, item),
                self._index(item),
            )
        if task == "index2item":
            if self.item_titles is None:
                instr = self._pick(_INDEX2ITEM_TEMPLATES["desc"]).format(
                    index=self._index(item)
                )
                return instr, self.item_texts[item - 1]
            subtype = _SUBTYPES[r.integers(len(_SUBTYPES))]
            instr = self._pick(_INDEX2ITEM_TEMPLATES[subtype]).format(
                index=self._index(item)
            )
            resp = {
                "title": self._title(item),
                "desc": self._description(item),
                "combined": f"{self._title(item)}\n\n{self._description(item)}",
            }[subtype]
            return instr, resp
        if task == "fusionseqrec" and len(body) >= 2:
            t = r.integers(1, len(body))
            tmpl = self._pick(_FUSIONSEQREC_TEMPLATES)
            target = int(body[t])
            # Joint index+title target (the reference answers with the
            # title; we emit index tokens then the title so the codebook
            # supervision signal survives).
            return (
                tmpl.format(history=self._history_str(body[:t])),
                f"{self._index(target)} {self._title(target)}",
            )
        if task == "itemsearch":
            tmpl = self._pick(_ITEMSEARCH_TEMPLATES)
            hist = self._history_str(body) if len(body) else self._index(item)
            return (
                tmpl.format(query=self._search_query(item), history=hist),
                self._index(item),
            )
        if task == "preferenceobtain" and len(body) >= 2:
            tmpl = self._pick(_PREFERENCE_TEMPLATES)
            return (
                tmpl.format(history=self._history_str(body)),
                self._preference_text(body),
            )
        # Fallback for short sequences.
        return (
            self._subtype_instruction(_ITEM2INDEX_TEMPLATES, item),
            self._index(item),
        )

    # ---- packing ----------------------------------------------------------

    def _pack(self, prompt: str, response: str):
        """Left-pad to max_len; labels = -100 on prompt and pad
        (lcrec_trainer.py:43-84)."""
        p_ids = self.tok.encode(prompt)
        r_ids = self.tok.encode(response) + [self.tok.eos_id]
        ids = (p_ids + r_ids)[-self.max_len :]
        n_prompt = max(0, min(len(p_ids), self.max_len - len(r_ids)))
        pad = self.max_len - len(ids)
        input_ids = np.full(self.max_len, self.tok.pad_id, np.int32)
        labels = np.full(self.max_len, -100, np.int32)
        mask = np.zeros(self.max_len, np.int32)
        input_ids[pad:] = ids
        mask[pad:] = 1
        labels[pad + n_prompt :] = ids[n_prompt:]
        return input_ids, mask, labels

    def _pack_prompt(self, prompt: str):
        p_ids = self.tok.encode(prompt)[-self.max_len :]
        pad = self.max_len - len(p_ids)
        input_ids = np.full(self.max_len, self.tok.pad_id, np.int32)
        mask = np.zeros(self.max_len, np.int32)
        input_ids[pad:] = p_ids
        mask[pad:] = 1
        return input_ids, mask

    def train_arrays(self, samples_per_user: int = 2) -> dict:
        out_i, out_m, out_l = [], [], []
        for seq in self.sequences:
            if len(seq) < 3:
                continue
            for _ in range(samples_per_user):
                task = TASKS[self.rng.choice(len(TASKS), p=self.task_weights)]
                prompt, response = self._sample_for(task, seq)
                i, m, l = self._pack(*alpaca_frame(prompt, response))
                out_i.append(i)
                out_m.append(m)
                out_l.append(l)
        return {
            "input_ids": np.stack(out_i),
            "attention_mask": np.stack(out_m),
            "labels": np.stack(out_l),
        }

    def eval_arrays(self, split: str = "valid") -> dict:
        """seqrec eval (amazon_lcrec.py:432-454): prompt without response;
        target = held-out item's sem-id tuple."""
        out_i, out_m, out_t = [], [], []
        for seq in self.sequences:
            if len(seq) < 3:
                continue
            hist = seq[:-2] if split == "valid" else seq[:-1]
            target = seq[-2] if split == "valid" else seq[-1]
            prompt, _ = alpaca_frame(
                _SEQREC_TEMPLATES[0].format(history=self._history_str(hist))
            )
            input_ids, mask = self._pack_prompt(prompt)
            out_i.append(input_ids)
            out_m.append(mask)
            out_t.append(self.sem_ids[target - 1])
        return {
            "input_ids": np.stack(out_i),
            "attention_mask": np.stack(out_m),
            "target_ids": np.stack(out_t).astype(np.int32),
        }

    def item2index_eval_arrays(self, max_items: int | None = None) -> dict:
        """Greedy item->index eval over the item set (the reference's
        item2index leg, lcrec_trainer.py:193-213): deterministic title
        template, target = the item's sem ids."""
        n = len(self.item_texts) if max_items is None else min(max_items, len(self.item_texts))
        out_i, out_m, out_t = [], [], []
        for item in range(1, n + 1):
            pools = _ITEM2INDEX_TEMPLATES["title" if self.item_titles is not None else "desc"]
            instr = pools[0].format(
                title=self._title(item), description=self.item_texts[item - 1]
            )
            input_ids, mask = self._pack_prompt(alpaca_frame(instr)[0])
            out_i.append(input_ids)
            out_m.append(mask)
            out_t.append(self.sem_ids[item - 1])
        return {
            "input_ids": np.stack(out_i),
            "attention_mask": np.stack(out_m),
            "target_ids": np.stack(out_t).astype(np.int32),
        }

    def index2item_eval_arrays(self, max_items: int | None = None):
        """Unconstrained index->item eval (lcrec_trainer.py:215-227):
        deterministic title template; returns (arrays, target_texts) —
        match = target title appearing in the generated text."""
        n = len(self.item_texts) if max_items is None else min(max_items, len(self.item_texts))
        out_i, out_m, texts = [], [], []
        for item in range(1, n + 1):
            instr = _INDEX2ITEM_TEMPLATES["title"][0].format(index=self._index(item))
            input_ids, mask = self._pack_prompt(alpaca_frame(instr)[0])
            out_i.append(input_ids)
            out_m.append(mask)
            texts.append(self._title(item))
        return (
            {"input_ids": np.stack(out_i), "attention_mask": np.stack(out_m)},
            texts,
        )


# ---------------------------------------------------------------------------
# Dataset factories.
# ---------------------------------------------------------------------------


def synthetic_lcrec_data(
    num_items: int = 100,
    codebook_size: int = 8,
    num_codebooks: int = 3,
    seed: int = 0,
    task_weights=DEFAULT_TASK_WEIGHTS,
    **seq_kwargs,
):
    from genrec_tpu_torch.data.sem_ids import random_unique_sem_ids
    from genrec_tpu_torch.data.synthetic import SyntheticSeqDataset

    ds = SyntheticSeqDataset(num_items=num_items, seed=seed, **seq_kwargs)
    sem_ids = random_unique_sem_ids(
        num_items, codebook_size, num_codebooks, np.random.default_rng(seed + 1)
    )
    adjectives = ["red", "blue", "soft", "small", "large", "shiny", "warm", "light"]
    nouns = ["cream", "ball", "shoe", "bag", "brush", "lotion", "soap", "towel"]
    item_texts = [
        f"{adjectives[i % len(adjectives)]} {nouns[(i // 8) % len(nouns)]} item{i}"
        for i in range(num_items)
    ]
    words = sorted({w for t in item_texts for w in t.split()} | _template_words())
    tok = WordTokenizer(words, num_codebooks, codebook_size)
    data = LCRecTaskData(
        ds.sequences, sem_ids, item_texts, tok, task_weights=task_weights
    )
    return data, tok


def load_lcrec_item_meta(root: str, split: str):
    """Per-item (titles, texts, categories), item id i+1 -> row i.

    Text assembly matches the reference's LCRec fields
    (amazon_lcrec.py:283-305): text = "<title> by <brand> (<cats>)" with
    absent parts dropped; category = first three entries of the LAST
    categories list, comma-joined; missing items render as item_<i>."""
    from genrec_tpu_torch.data.amazon import DATASET_FILES, load_item_asins, parse_gzip_json
    import os

    asins = load_item_asins(root, split)
    meta_path = os.path.join(root, "raw", split, DATASET_FILES[split]["meta"])
    metas = {}
    if os.path.exists(meta_path):
        metas = {r.get("asin"): r for r in parse_gzip_json(meta_path) if r.get("asin")}
    titles, texts, cats = [], [], []
    for i, a in enumerate(asins):
        meta = metas.get(a, {})
        title = (meta.get("title") or "").strip()
        brand = (meta.get("brand") or "").strip()
        cat_lists = meta.get("categories") or []
        cat = ", ".join(cat_lists[-1][:3]) if cat_lists else ""
        text = title
        if brand:
            text += f" by {brand}"
        if cat:
            text += f" ({cat})"
        text = text.strip() or f"item_{i}"
        titles.append(title or f"item_{i}")
        texts.append(text)
        cats.append(cat)
    return titles, texts, cats


def amazon_lcrec_data(
    root: str,
    split: str,
    sem_ids_path: str,
    tokenizer=None,
    max_len: int = 256,
    max_history: int = 20,
    task_weights=DEFAULT_TASK_WEIGHTS,
    seed: int = 0,
):
    """Real-data LCRec task source: sequences + meta text from the Amazon
    dump, sem ids from the RQ-VAE artifact, HF tokenizer when provided
    (WordTokenizer fallback otherwise). Returns (data, tok)."""
    from genrec_tpu_torch.data.amazon import load_sequences
    from genrec_tpu_torch.data.sem_ids import load_sem_ids

    seqs, _, num_items = load_sequences(root, split, download=False)
    sem_ids, codebook_size = load_sem_ids(sem_ids_path)
    if len(sem_ids) < num_items:
        raise ValueError(
            f"sem-id artifact covers {len(sem_ids)} items but the sequence "
            f"data has {num_items}"
        )
    num_codebooks = sem_ids.shape[1]
    titles, texts, cats = load_lcrec_item_meta(root, split)

    if tokenizer is None:
        words = sorted(
            {w for t in texts for w in t.split()}
            | {w for t in cats for w in t.split()}
            | _template_words()
        )
        tok = WordTokenizer(words, num_codebooks, codebook_size)
    elif isinstance(tokenizer, (WordTokenizer, HFTokenizerAdapter)):
        tok = tokenizer
    else:
        tok = HFTokenizerAdapter(tokenizer, num_codebooks, codebook_size)

    data = LCRecTaskData(
        seqs,
        sem_ids,
        texts,
        tok,
        max_len=max_len,
        max_history=max_history,
        task_weights=task_weights,
        seed=seed,
        item_titles=titles,
        item_categories=cats,
        numbered_history=True,
    )
    return data, tok
