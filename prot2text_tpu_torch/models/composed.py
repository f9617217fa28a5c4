"""Composed protein→text models (counterpart of
prot2text_tpu/models/composed.py):
  * `Esm2LlamaInstructForCausalLM` (:52-163, reference
    modeling_esm2llama_instruct.py:71-268): ESM2 encoder + modality adapter
    + Llama with placeholder-token fusion;
  * `ESMCQwen` (:462-604, reference esmc_qwen_arc.py:31-273): ESMC encoder
    + modality adapter + Qwen3, the model of `cli/serve.py` and
    `cli/generate_instruct_light.py` (lockstep `generate`);
  * `Esm2LlamaForCausalLM` (:171-334, reference
    modeling_esm2llama_legacy.py:127-574): the legacy arc, ESM2 encoder
    (+ Linear + LayerNorm adapter) concatenated in front of the text
    embeds, fully fine-tuned (`train/legacy.py`).
The RGCN arc is not ported yet (ROADMAP.md §1 item 12).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch
from torch import nn

from ..data.tokenization import ProteinTokenizer, esmc_tokenizer
from .adapters import (
    ModalityAdapterConfig, init_modality_adapter_params, modality_adapter,
)
from .decoder import (
    contiguous_lengths, cross_entropy_loss, decoder_forward, decoder_logits,
    embed_tokens,
)
from .esm2 import ESM2Config, esm2_encode, init_esm2_params
from .esmc import ESMCConfig, esmc_encode, init_esmc_params
from .fusion import concat_fusion, count_check, placeholder_merge
from .llama import LlamaConfig, init_llama_params
from .qwen3 import Qwen3Config, init_qwen3_params
from .transformer import layer_norm, linear
from .weights import ParamTree, dense, tree_map


@dataclasses.dataclass
class ModelOutput:
    loss: Optional[torch.Tensor] = None
    logits: Optional[torch.Tensor] = None
    hidden_states: Optional[torch.Tensor] = None


@dataclasses.dataclass(frozen=True)
class Esm2LlamaInstructConfig:
    esm_config: ESM2Config
    adapter_config: ModalityAdapterConfig
    llama_config: LlamaConfig
    placeholder_id: int = 128003


def init_instruct_params(config: Esm2LlamaInstructConfig, *, generator,
                         device, dtype=torch.float32) -> dict:
    """{"esm_encoder", "adapter", "llama_decoder"} drawn on `device` from
    `generator` (N(0, 0.02), as the JAX init)."""
    kw = dict(generator=generator, device=device, dtype=dtype)
    return {
        "esm_encoder": init_esm2_params(config.esm_config, **kw),
        "adapter": init_modality_adapter_params(config.adapter_config, **kw),
        "llama_decoder": init_llama_params(config.llama_config, **kw),
    }


class Esm2LlamaInstructForCausalLM(nn.Module):
    """ESM2 + ModalityAdapter + Llama with placeholder-token fusion.

    `params`: a ParamTree (e.g. `models.weights.params_from_jax(...)`) or a
    nested dict of tensors with the JAX tree {"esm_encoder", "adapter",
    "llama_decoder"}; None draws random weights on `device` from
    `generator` (N(0, 0.02), as the JAX init).

    `attn_impl` routes the encoder and the prefill as `apply` does
    ("auto": plain ESM2 attention, K1 in the prefill; "flash": K6 in ESM2
    too; "xla": the plain function everywhere); decode has one route per
    cache (K4 per layer, or K12 on the tbkd cache)."""

    PARTS = ("esm_encoder", "adapter", "llama_decoder")

    def __init__(self, config: Esm2LlamaInstructConfig, params=None, *,
                 device="cpu", dtype=torch.float32, generator=None,
                 attn_impl: str = "auto"):
        super().__init__()
        self.config = config
        self.attn_impl = attn_impl
        if params is None:
            if generator is None:
                generator = torch.Generator(device=device).manual_seed(0)
            params = init_instruct_params(config, generator=generator,
                                          device=device, dtype=dtype)
        tree = params if isinstance(params, ParamTree) else ParamTree(params)
        for name in self.PARTS:
            self.add_module(name, getattr(tree, name))

    def params(self) -> dict:
        return {name: getattr(self, name).tree() for name in self.PARTS}

    @staticmethod
    def apply(config: Esm2LlamaInstructConfig, params, *, input_ids=None,
              attention_mask=None, labels=None, protein_input_ids=None,
              protein_attention_mask=None, protein_inputs_embeds=None,
              return_encoder_outputs: bool = False,
              return_adapter_outputs: bool = False,
              return_decoder_inputs: bool = False,
              deterministic: bool = True, attn_impl: str = "auto"):
        enc = esm2_encode(config.esm_config, params["esm_encoder"],
                          protein_input_ids, protein_attention_mask,
                          inputs_embeds=protein_inputs_embeds,
                          attn_impl=attn_impl)
        if return_encoder_outputs:
            return enc
        adapted = modality_adapter(config.adapter_config, params["adapter"],
                                   enc, deterministic=deterministic)
        if return_adapter_outputs:
            return adapted, protein_attention_mask
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        dec = params["llama_decoder"]
        text_embeds = embed_tokens(dec, input_ids)
        inputs_embeds = placeholder_merge(
            text_embeds, input_ids, adapted, protein_attention_mask,
            config.placeholder_id)
        if return_decoder_inputs:
            return inputs_embeds, attention_mask
        core = config.llama_config.core()
        B, S = input_ids.shape
        positions = torch.arange(S, device=input_ids.device).expand(B, S)
        h, _ = decoder_forward(
            core, dec, inputs_embeds=inputs_embeds, positions=positions,
            attn_lengths=contiguous_lengths(attention_mask),
            attn_impl=attn_impl)
        logits = decoder_logits(core, dec, h)
        loss = None if labels is None else cross_entropy_loss(logits, labels)
        return ModelOutput(loss=loss, logits=logits, hidden_states=h)

    @torch.no_grad()
    def forward(self, **kw):
        kw.setdefault("attn_impl", self.attn_impl)
        return self.apply(self.config, self.params(), **kw)

    @torch.no_grad()
    def generate(self, inputs, attention_mask=None, protein_input_ids=None,
                 protein_attention_mask=None, protein_inputs_embeds=None,
                 generator=None, **gen_kwargs):
        """Prompt-only inputs; returns ONLY the new tokens (B,
        max_new_tokens).  A `stats` dict is passed on to
        `infer.generate.run_generation`, and so are the prompt's ids (which
        prompt lookup drafts from).  Raises ValueError when a row's
        placeholder count differs from its protein-token count."""
        from ..infer.generate import resolve_generation_config, run_generation

        if protein_attention_mask is not None and not bool(count_check(
                inputs, self.config.placeholder_id,
                protein_attention_mask).all()):
            raise ValueError("Number of placeholder tokens must match number "
                             "of protein tokens")
        params = self.params()
        # the text prompt's ids, which prompt lookup drafts from
        text_ids, text_mask = inputs, attention_mask
        inputs_embeds, attention_mask = self.apply(
            self.config, params, input_ids=inputs,
            attention_mask=attention_mask,
            protein_input_ids=protein_input_ids,
            protein_attention_mask=protein_attention_mask,
            protein_inputs_embeds=protein_inputs_embeds,
            return_decoder_inputs=True, attn_impl=self.attn_impl)
        kv_bits = gen_kwargs.pop("kv_bits", None)
        stats = gen_kwargs.pop("stats", None)
        lc = self.config.llama_config
        gen_cfg = resolve_generation_config(lc.eos_token_id, lc.pad_token_id,
                                            gen_kwargs)
        return run_generation(
            lc.core(), params["llama_decoder"], inputs_embeds=inputs_embeds,
            attention_mask=attention_mask, gen_cfg=gen_cfg,
            generator=generator, kv_bits=kv_bits, stats=stats,
            attn_impl=self.attn_impl, prompt_ids=text_ids,
            prompt_ids_mask=text_mask)


# ---------------------------------------------------------------------------
# ESMCQwen


@dataclasses.dataclass(frozen=True)
class ESMCQwenConfig:
    """Reference models/esmc_config.py:5-22."""

    esm_config: ESMCConfig
    adapter_config: ModalityAdapterConfig
    llm_config: Qwen3Config
    placeholder_id: int = 151669  # added special token in the Qwen vocab
    llm_model_name: str = "Qwen/Qwen3-14B"
    esm_model_name: str = "esmc_600m"


class ESMCQwen(nn.Module):
    """ESMC + ModalityAdapter + Qwen3: raw protein strings or pre-tokenized
    proteins in, text out.

    `params`: a ParamTree or a nested dict of tensors with the JAX tree
    {"esm_encoder", "adapter", "llm_decoder"}; None draws random weights on
    `device` from `generator`.  `attn_impl` routes `forward`, `generate`
    and `encode_protein_sequences` as `apply` does ("auto": plain ESMC, K1
    in the decoder; "flash": K6 in ESMC too; "xla": the plain function
    everywhere)."""

    PARTS = ("esm_encoder", "adapter", "llm_decoder")

    def __init__(self, config: ESMCQwenConfig, params=None, *,
                 device="cpu", dtype=torch.float32, generator=None,
                 attn_impl: str = "auto",
                 tokenizer: Optional[ProteinTokenizer] = None):
        super().__init__()
        self.config = config
        self.attn_impl = attn_impl
        self.protein_tokenizer = tokenizer or esmc_tokenizer()
        if params is None:
            if generator is None:
                generator = torch.Generator(device=device).manual_seed(0)
            kw = dict(generator=generator, device=device, dtype=dtype)
            params = {
                "esm_encoder": init_esmc_params(config.esm_config, **kw),
                "adapter": init_modality_adapter_params(
                    config.adapter_config, **kw),
                "llm_decoder": init_qwen3_params(config.llm_config, **kw),
            }
        tree = params if isinstance(params, ParamTree) else ParamTree(params)
        for name in self.PARTS:
            self.add_module(name, getattr(tree, name))

    def _tokenize(self, protein_sequences: List[str], pad_to=None):
        """Host tokenization → right-padded (ids, mask) int64 tensors on
        the model's device."""
        dev = self.esm_encoder.tree()["embed"].device
        ids, mask = self.protein_tokenizer.batch_encode(protein_sequences,
                                                        pad_to=pad_to)
        return (torch.as_tensor(ids, dtype=torch.int64, device=dev),
                torch.as_tensor(mask, dtype=torch.int64, device=dev))

    @torch.no_grad()
    def encode_protein_sequences(self, protein_sequences: List[str],
                                 pad_to: Optional[int] = None):
        """Tokenize (host) + ESMC encode (device) → (embeddings (B, P, d),
        mask (B, P)) (prot2text_tpu/models/composed.py:495): tokenization is
        a separable host step, unlike the reference's forward
        (esmc_qwen_arc.py:70-78)."""
        ids, mask = self._tokenize(protein_sequences, pad_to)
        emb = esmc_encode(self.config.esm_config, self.esm_encoder.tree(),
                          ids, mask, attn_impl=self.attn_impl)
        return emb, mask

    def params(self) -> dict:
        return {name: getattr(self, name).tree() for name in self.PARTS}

    @staticmethod
    def apply(config: ESMCQwenConfig, params, *, protein_input_ids,
              protein_attention_mask, input_ids=None, attention_mask=None,
              labels=None, return_encoder_outputs: bool = False,
              return_decoder_inputs: bool = False,
              deterministic: bool = True, generator=None,
              attn_impl: str = "auto"):
        """The JAX `ESMCQwen.apply`: protein ids (B, P) right-padded, prompt
        ids (B, S) left-padded.  `return_encoder_outputs` → (adapter
        output,); `return_decoder_inputs` → (inputs_embeds, attention_mask),
        the serving CLI's hand-off to the engine; else a ModelOutput.
        `attn_impl` routes both towers as `decoder_forward` and
        `esmc_encode` do ("auto": plain ESMC, K1 in the decoder)."""
        enc = esmc_encode(config.esm_config, params["esm_encoder"],
                          protein_input_ids, protein_attention_mask,
                          attn_impl=attn_impl)
        adapted = modality_adapter(config.adapter_config, params["adapter"],
                                   enc, deterministic=deterministic,
                                   generator=generator)
        if return_encoder_outputs:
            return (adapted,)
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        dec = params["llm_decoder"]
        inputs_embeds = placeholder_merge(
            embed_tokens(dec, input_ids), input_ids, adapted,
            protein_attention_mask, config.placeholder_id)
        if return_decoder_inputs:
            return inputs_embeds, attention_mask
        core = config.llm_config.core()
        B, S = input_ids.shape
        positions = torch.arange(S, device=input_ids.device).expand(B, S)
        h, _ = decoder_forward(
            core, dec, inputs_embeds=inputs_embeds, positions=positions,
            attn_lengths=contiguous_lengths(attention_mask),
            attn_impl=attn_impl)
        logits = decoder_logits(core, dec, h)
        loss = None if labels is None else cross_entropy_loss(logits, labels)
        return ModelOutput(loss=loss, logits=logits, hidden_states=h)

    @torch.no_grad()
    def forward(self, protein_sequences: Optional[List[str]] = None, *,
                protein_input_ids=None, protein_attention_mask=None, **kw):
        """`apply` on this model's params and route (raw `protein_sequences`
        are tokenized first), after the reference's check that every row
        has one placeholder per valid protein token (esmc_qwen_arc.py:
        137-141)."""
        if protein_sequences is not None:
            protein_input_ids, protein_attention_mask = self._tokenize(
                protein_sequences)
        if (kw.get("input_ids") is not None
                and not kw.get("return_encoder_outputs", False)
                and not bool(count_check(kw["input_ids"],
                                         self.config.placeholder_id,
                                         protein_attention_mask).all())):
            raise ValueError("Number of placeholder tokens must match number "
                             "of protein tokens")
        kw.setdefault("attn_impl", self.attn_impl)
        return self.apply(self.config, self.params(),
                          protein_input_ids=protein_input_ids,
                          protein_attention_mask=protein_attention_mask, **kw)

    @torch.no_grad()
    def generate(self, input_ids, attention_mask=None,
                 protein_sequences: Optional[List[str]] = None,
                 protein_input_ids=None, protein_attention_mask=None,
                 generator=None, **gen_kwargs):
        """Lockstep generation (prot2text_tpu/models/composed.py:578-604):
        `forward(return_decoder_inputs=True)`, then `run_generation` with
        `kv_bits` from the keyword arguments and the prompt ids (which
        prompt lookup drafts from).  Returns ONLY the new tokens (B,
        max_new_tokens); a `stats` dict is passed on to `run_generation`."""
        from ..infer.generate import resolve_generation_config, run_generation

        if protein_sequences is None and protein_input_ids is None:
            raise ValueError("protein_sequences must be provided for "
                             "generation")
        text_ids, text_mask = input_ids, attention_mask
        inputs_embeds, attention_mask = self.forward(
            protein_sequences, protein_input_ids=protein_input_ids,
            protein_attention_mask=protein_attention_mask,
            input_ids=input_ids, attention_mask=attention_mask,
            return_decoder_inputs=True)
        kv_bits = gen_kwargs.pop("kv_bits", None)
        stats = gen_kwargs.pop("stats", None)
        qc = self.config.llm_config
        gen_cfg = resolve_generation_config(qc.eos_token_id, qc.pad_token_id,
                                            gen_kwargs)
        return run_generation(
            qc.core(), self.llm_decoder.tree(), inputs_embeds=inputs_embeds,
            attention_mask=attention_mask, gen_cfg=gen_cfg,
            generator=generator, kv_bits=kv_bits, stats=stats,
            attn_impl=self.attn_impl, prompt_ids=text_ids,
            prompt_ids_mask=text_mask)


# ---------------------------------------------------------------------------
# Legacy Esm2LlamaForCausalLM (concat fusion)


@dataclasses.dataclass(frozen=True)
class Esm2LlamaConfig:
    """Reference configuration_esm2llama_legacy.py:29-162 (composite)."""

    esm_config: ESM2Config
    llama_config: LlamaConfig
    decoder_hidden_size: Optional[int] = None  # enables linear adapter + LN
    bos_token_id: int = 128000
    eos_token_id: int = 128001  # base (non-instruct) eos


def hf_towers(esm_config: ESM2Config, llama_config: LlamaConfig, *,
              esm_checkpoint_dir=None, llama_checkpoint_dir=None,
              device="cpu", dtype=torch.float32) -> dict:
    """{"esm_encoder"?, "llama_decoder"?}: the towers whose HF directory is
    given, read by `models/hf_import.py` onto `device` in `dtype` (the
    Llama tower ties its embeddings as `llama_config` says); the keys of
    `Esm2LlamaForCausalLM` and `Esm2LlamaInstructForCausalLM` alike."""
    from .hf_import import (
        decoder_params_from_hf, esm2_params_from_hf, load_state_dict_dir,
    )

    out = {}
    if esm_checkpoint_dir:
        out["esm_encoder"] = esm2_params_from_hf(
            load_state_dict_dir(esm_checkpoint_dir), esm_config.num_layers,
            device=device, dtype=dtype)
    if llama_checkpoint_dir:
        out["llama_decoder"] = decoder_params_from_hf(
            load_state_dict_dir(llama_checkpoint_dir),
            llama_config.num_layers, device=device, dtype=dtype,
            tie_word_embeddings=llama_config.tie_word_embeddings)
    return out


def init_esm2llama_params(config: Esm2LlamaConfig, *, generator, device,
                          dtype=torch.float32) -> dict:
    """{"esm_encoder", "llama_decoder"[, "encoder_adapter"]} drawn on
    `device` with the JAX init's law; the adapter {dense: {kernel, bias},
    ln: {scale, bias}} exists with `decoder_hidden_size`
    (prot2text_tpu/models/composed.py:236-246)."""
    kw = dict(generator=generator, device=device, dtype=dtype)
    params = {"esm_encoder": init_esm2_params(config.esm_config, **kw),
              "llama_decoder": init_llama_params(config.llama_config, **kw)}
    if config.decoder_hidden_size is not None:
        h_out = config.decoder_hidden_size
        params["encoder_adapter"] = {
            "dense": dense(config.esm_config.hidden_size, h_out, bias=True,
                           **kw),
            "ln": {"scale": torch.ones(h_out, device=device, dtype=dtype),
                   "bias": torch.zeros(h_out, device=device, dtype=dtype)},
        }
    return params


class Esm2LlamaForCausalLM(nn.Module):
    """ESM2 encoder (+ Linear + LayerNorm adapter) concatenated in front of
    the text embeds (reference modeling_esm2llama_legacy.py:294-360).

    `params`: a ParamTree or nested dict with the JAX tree (e.g. a
    `train_legacy` checkpoint's "model"); None draws random weights on
    `device` from `generator`.  `attn_impl` routes attention as
    `esm2_encode` and `decoder_forward` do: "auto" plain ESM2 attention
    and K1 (K5 backward) in the decoder, "flash" also K6/K6b in ESM2, "xla"
    the plain function everywhere; generation decodes through the
    lockstep step (K12 on the D=64 tbkd cache)."""

    PARTS = ("esm_encoder", "llama_decoder", "encoder_adapter")

    def __init__(self, config: Esm2LlamaConfig, params=None, *,
                 device="cpu", dtype=torch.float32, generator=None,
                 attn_impl: str = "auto"):
        super().__init__()
        self.config = config
        self.attn_impl = attn_impl
        if params is None:
            if generator is None:
                generator = torch.Generator(device=device).manual_seed(0)
            params = init_esm2llama_params(config, generator=generator,
                                           device=device, dtype=dtype)
        tree = params if isinstance(params, ParamTree) else ParamTree(params)
        self.parts = [n for n in self.PARTS if n in tree._modules]
        for name in self.parts:
            self.add_module(name, getattr(tree, name))

    @classmethod
    def from_pretrained(cls, config: Esm2LlamaConfig, *,
                        combined_checkpoint_dir=None,
                        esm_checkpoint_dir=None, llama_checkpoint_dir=None,
                        dtype=None, device="cpu", generator=None,
                        attn_impl: str = "auto"):
        """The JAX loading modes: a combined checkpoint (the port's
        `step_N/checkpoint.pt`, its "model" tree; `dtype` casts its float
        leaves when given), else random weights in `dtype` (f32 by
        default) with the towers of the HF directories given
        (`esm_checkpoint_dir` and/or `llama_checkpoint_dir`, `hf_towers`)
        in their place; a tower not given stays random."""
        if not combined_checkpoint_dir:
            dtype = dtype or torch.float32
            if generator is None:
                generator = torch.Generator(device=device).manual_seed(0)
            params = init_esm2llama_params(config, generator=generator,
                                           device=device, dtype=dtype)
            params.update(hf_towers(
                config.esm_config, config.llama_config,
                esm_checkpoint_dir=esm_checkpoint_dir,
                llama_checkpoint_dir=llama_checkpoint_dir, device=device,
                dtype=dtype))
            return cls(config, params, attn_impl=attn_impl)
        from ..core.checkpoint import restore_checkpoint

        restored = restore_checkpoint(combined_checkpoint_dir,
                                      map_location=device)
        params = restored.get("model", restored)
        if dtype is not None:
            params = tree_map(lambda t: t.to(dtype) if t.is_floating_point()
                              else t, params)
        return cls(config, params, attn_impl=attn_impl)

    def params(self) -> dict:
        return {name: getattr(self, name).tree() for name in self.parts}

    def predict_contacts(self, *a, **kw):
        """The legacy encoder wrapper strips the contact head: this raises,
        as in the reference (modeling_esm2llama_legacy.py:115-124)."""
        raise NotImplementedError(
            "contact prediction head is removed from the encoder")

    @staticmethod
    def apply(config: Esm2LlamaConfig, params, *, input_ids=None,
              attention_mask=None, labels=None, protein_input_ids=None,
              protein_attention_mask=None,
              return_encoder_output: bool = False, encoder_output=None,
              attn_impl: str = "auto", remat: bool = False):
        """Logits and, with `labels`, the loss over [enc ‖ text];
        `return_encoder_output` → (adapted encoder states, protein mask);
        `encoder_output` skips the encoder.  Positions are arange(S) over
        the whole sequence, the protein's left padding included, as in
        JAX (generation counts valid tokens instead)."""
        if encoder_output is None:
            enc = esm2_encode(config.esm_config, params["esm_encoder"],
                              protein_input_ids, protein_attention_mask,
                              attn_impl=attn_impl, remat=remat)
            if "encoder_adapter" in params:
                enc = linear(params["encoder_adapter"]["dense"], enc)
                enc = layer_norm(params["encoder_adapter"]["ln"], enc)
            enc_mask = protein_attention_mask
        else:
            enc, enc_mask = encoder_output
        if return_encoder_output:
            return enc, enc_mask
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        dec = params["llama_decoder"]
        inputs_embeds, full_mask, full_labels = concat_fusion(
            enc, enc_mask, embed_tokens(dec, input_ids), attention_mask,
            labels)
        core = config.llama_config.core()
        B, S = full_mask.shape
        positions = torch.arange(S, device=full_mask.device).expand(B, S)
        # the key runs of the WHOLE [enc ‖ text] mask (one contiguous run
        # in the derived collator's layout); JAX passes the text mask's
        # (composed.py:289), which only its TPU flash route reads
        h, _ = decoder_forward(
            core, dec, inputs_embeds=inputs_embeds, positions=positions,
            attn_lengths=contiguous_lengths(full_mask), attn_impl=attn_impl,
            remat=remat)
        logits = decoder_logits(core, dec, h)
        loss = (None if full_labels is None
                else cross_entropy_loss(logits, full_labels))
        return ModelOutput(loss=loss, logits=logits, hidden_states=h)

    @torch.no_grad()
    def forward(self, **kw):
        return self.apply(self.config, self.params(),
                          attn_impl=self.attn_impl, **kw)

    @torch.no_grad()
    def generate(self, inputs=None, attention_mask=None,
                 protein_input_ids=None, protein_attention_mask=None,
                 generator=None, **gen_kwargs):
        """Output INCLUDES the prompt ids (reference
        modeling_esm2llama_legacy.py:505-507, :574): (B, prompt +
        max_new_tokens).  The default prompt is one bos per row
        (:553-560).  `kv_bits`, `stats` and the prompt's ids (which prompt
        lookup drafts from) are passed on to `infer.generate.run_generation`."""
        from ..infer.generate import resolve_generation_config, run_generation

        params = self.params()
        enc, enc_mask = self.apply(
            self.config, params, protein_input_ids=protein_input_ids,
            protein_attention_mask=protein_attention_mask,
            return_encoder_output=True, attn_impl=self.attn_impl)
        B = enc.shape[0]
        if inputs is None:
            inputs = torch.full((B, 1), self.config.bos_token_id,
                                dtype=torch.int64, device=enc.device)
            attention_mask = torch.ones_like(inputs)
        if attention_mask is None:
            attention_mask = torch.ones_like(inputs)
        inputs_embeds, full_mask, _ = concat_fusion(
            enc, enc_mask, embed_tokens(params["llama_decoder"], inputs),
            attention_mask)
        kv_bits = gen_kwargs.pop("kv_bits", None)
        stats = gen_kwargs.pop("stats", None)
        lc = self.config.llama_config
        gen_cfg = resolve_generation_config(self.config.eos_token_id,
                                            lc.pad_token_id, gen_kwargs)
        new_tokens = run_generation(
            lc.core(), params["llama_decoder"], inputs_embeds=inputs_embeds,
            attention_mask=full_mask, gen_cfg=gen_cfg, generator=generator,
            kv_bits=kv_bits, stats=stats, attn_impl=self.attn_impl,
            prompt_ids=inputs, prompt_ids_mask=attention_mask)
        return torch.cat([inputs.to(new_tokens.dtype), new_tokens], dim=1)
