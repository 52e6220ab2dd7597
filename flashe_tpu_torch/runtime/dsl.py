"""FATE-compatible job DSL: component DAG parsing + execution (port of
flashe_tpu/runtime/dsl.py; every component runs on the `device` that the
caller passes down, the card unless it asks for the CPU).

The reference submits jobs as two JSON files — a DSL describing the
component graph and a conf carrying per-role and per-component parameters
(`python fate_flow_client.py -f submit_job -d train_job_dsl.json -c
train_job_conf.json`, fate_flow/fate_flow_client.py:196-225).  fate_flow
parses the DSL, topologically walks the components and spawns one task
per (component, role, party) (fate_flow/driver/dsl_parser.py;
task_scheduler.py:133-315).

This module reproduces that surface library-sized: `parse_dsl` returns
the topologically-ordered component specs, `JobConf` resolves the
reference conf layout (initiator / role party lists / role_parameters
with per-party list indexing / algorithm_parameters), and `run_dsl_job`
executes the pipeline — every role walks the DAG, DataIO feeds tables
from the dataset store, JZFHomoNN runs the federated training loop over
the secure aggregator, Evaluation scores the predictions.  Reference job
confs work unchanged: the Keras `nn_define` JSON is interpreted directly
(flashe_tpu_torch/nn/keras_define.py), including the
`config.name == "lstm"` next-token label construction
(enter_point.py:160-166, jzf_nn_model.py:238-248).

Supported modules: DataIO (federatedml/util/data_io.py DenseFeatureReader
semantics), JZFHomoNN / HomoNN (federatedml/nn/jzf_homo_nn), Evaluation
(federatedml/evaluation).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from flashe_tpu_torch.runtime.config import (
    CVParam, HomoNNParam, QuantizeConfig, SecureAggregateArgs,
)

__all__ = ["ComponentSpec", "JobConf", "parse_dsl", "translate_homo_nn",
           "run_dsl_job", "client_pipeline", "arbiter_pipeline"]

_SUPPORTED_MODULES = ("DataIO", "JZFHomoNN", "HomoNN", "Evaluation")


@dataclasses.dataclass
class ComponentSpec:
    name: str
    module: str
    data_inputs: Dict[str, List[str]]  # slot -> ["args.train_data" | "c.out"]
    data_outputs: List[str]

    def input_refs(self) -> List[str]:
        return [r for refs in self.data_inputs.values() for r in refs]


def parse_dsl(dsl: dict) -> List[ComponentSpec]:
    """Parse a DSL dict into topologically-ordered component specs.

    Mirrors fate_flow's dsl_parser: a component's inputs reference either
    job args ("args.train_data") or an upstream output
    ("dataio_0.train"); the returned order satisfies every such edge.
    """
    comps: Dict[str, ComponentSpec] = {}
    for name, spec in dsl.get("components", {}).items():
        module = spec.get("module", "")
        if module not in _SUPPORTED_MODULES:
            raise ValueError(
                f"component {name}: unsupported module {module!r} "
                f"(supported: {_SUPPORTED_MODULES})")
        data_in = spec.get("input", {}).get("data", {})
        comps[name] = ComponentSpec(
            name=name, module=module,
            data_inputs={k: list(v) for k, v in data_in.items()},
            data_outputs=list(spec.get("output", {}).get("data", [])),
        )

    # topological sort over upstream-component edges
    order: List[ComponentSpec] = []
    placed: set = set()
    pending = dict(comps)
    while pending:
        progressed = False
        for name, comp in list(pending.items()):
            deps = {r.split(".", 1)[0] for r in comp.input_refs()
                    if not r.startswith("args.")}
            unknown = deps - set(comps)
            if unknown:
                raise ValueError(
                    f"component {name}: unknown upstream {sorted(unknown)}")
            if deps <= placed:
                order.append(comp)
                placed.add(name)
                del pending[name]
                progressed = True
        if not progressed:
            raise ValueError(f"component cycle among {sorted(pending)}")
    return order


@dataclasses.dataclass
class JobConf:
    """The reference train_job_conf.json layout."""

    initiator: Dict[str, Any]
    roles: Dict[str, List[int]]
    role_parameters: Dict[str, Dict[str, Any]]
    algorithm_parameters: Dict[str, Dict[str, Any]]
    job_parameters: Dict[str, Any]

    @classmethod
    def parse(cls, conf: dict) -> "JobConf":
        roles = {r: list(ids) for r, ids in conf.get("role", {}).items()}
        if not roles.get("guest"):
            raise ValueError("conf.role.guest must list one party")
        if not roles.get("arbiter"):
            raise ValueError("conf.role.arbiter must list one party")
        return cls(
            initiator=conf.get("initiator", {}),
            roles=roles,
            role_parameters=conf.get("role_parameters", {}),
            algorithm_parameters=conf.get("algorithm_parameters", {}),
            job_parameters=conf.get("job_parameters", {}),
        )

    @property
    def n_hosts(self) -> int:
        return len(self.roles.get("host", []))

    def component_param(self, comp: str, role: str, ordinal: int) -> dict:
        """algorithm_parameters[comp] overlaid with the role's per-party
        values (role_parameters lists are indexed by party ordinal,
        matching fate_flow's runtime-conf merge)."""
        merged = dict(self.algorithm_parameters.get(comp, {}))
        role_comp = self.role_parameters.get(role, {}).get(comp, {})
        for key, values in role_comp.items():
            if isinstance(values, list) and values:
                merged[key] = values[min(ordinal, len(values) - 1)]
            else:
                merged[key] = values
        return merged

    def args_data(self, role: str, ordinal: int, slot: str) -> dict:
        """Resolve args.<slot> for one party: the {name, namespace} table
        locator from role_parameters.<role>.args.data.<slot>[ordinal]."""
        data = (self.role_parameters.get(role, {}).get("args", {})
                .get("data", {}).get(slot, []))
        if not data:
            raise ValueError(f"no args.{slot} for role {role}")
        return data[min(ordinal, len(data) - 1)]


def translate_homo_nn(ap: dict) -> Tuple[HomoNNParam, bool]:
    """Reference algorithm_parameters.homo_nn_0 -> HomoNNParam.

    Returns (param, create_label): create_label is True for the
    reference's LSTM next-token workload (nn_define config.name ==
    "lstm", enter_point.py:160-166).
    """
    saa_in = ap.get("secure_aggregate_args", {}) or {}
    saa = SecureAggregateArgs.from_dict(saa_in)
    opt = ap.get("optimizer", {})
    if isinstance(opt, str):
        opt_name, lr = opt, 5e-4
    else:
        opt_name = opt.get("optimizer", "adam")
        lr = float(opt.get("learning_rate", 5e-4))
    early = ap.get("early_stop", {})
    if isinstance(early, str):
        early = {"early_stop": early}

    create_label = False
    model_kwargs: Dict[str, Any] = dict(ap.get("model_kwargs", {}))
    if "model" in ap:  # our registry extension
        model = ap["model"]
    elif "nn_define" in ap:
        model = "nn_define"
        model_kwargs["nn_define"] = ap["nn_define"]
        create_label = (
            ap["nn_define"].get("config", {}).get("name") == "lstm")
    else:
        raise ValueError("homo_nn parameters need 'nn_define' or 'model'")

    param = HomoNNParam(
        model=model,
        model_kwargs=model_kwargs,
        secure_aggregate=ap.get("secure_aggregate", "flashe"),
        secure_aggregate_args=saa,
        sparsity=float(ap.get("sparsity", 1.0)),
        optimizer=opt_name.lower(),
        learning_rate=lr,
        loss=ap.get("loss", "categorical_crossentropy"),
        max_iter=int(ap.get("max_iter", 10)),
        batch_size=int(ap.get("batch_size", 128)),
        aggregate_every_n_epoch=int(ap.get("aggregate_every_n_epoch", 1)),
        early_stop=early.get("early_stop", "diff"),
        eps=float(early.get("eps", 1e-4)),
        early_stop_enabled=bool(ap.get("early_stop_enabled", False)),
    )
    cv_in = ap.get("cv_param") or ap.get("cv")
    if isinstance(cv_in, dict):
        param.cv = CVParam(
            need_cv=bool(cv_in.get("need_cv", True)),
            n_splits=int(cv_in.get("n_splits", 5)),
            shuffle=bool(cv_in.get("shuffle", True)),
            random_seed=int(cv_in.get("random_seed", 0)))
    if (param.secure_aggregate not in ("plain", "ckks", "additive")
            and param.secure_aggregate_args.quantize is None):
        # reference confs always carry quantize args for these schemes
        param.secure_aggregate_args.quantize = QuantizeConfig()
    param.check()
    return param, create_label


def _load_table(store, locator: dict):
    from flashe_tpu_torch.data.store import default_store

    st = store or default_store()
    x, y, _meta = st.load(locator["namespace"], locator["name"])
    return x, y


def _dataio(comp: ComponentSpec, conf: JobConf, role: str, ordinal: int,
            store) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """DataIO: resolve the args table and apply label settings
    (DenseFeatureReader semantics: with_label / label_type)."""
    params = conf.component_param(comp.name, role, ordinal)
    slot = comp.data_inputs.get("data", ["args.train_data"])[0]
    if not slot.startswith("args."):
        raise ValueError(f"DataIO {comp.name}: input must be an args ref")
    locator = conf.args_data(role, ordinal, slot.split(".", 1)[1])
    x, y = _load_table(store, locator)
    if not params.get("with_label", True):
        y = None
    elif y is not None and params.get("label_type", "int") == "int":
        y = np.asarray(y).astype(np.int64)
    return x, y


def client_pipeline(trv, components: List[ComponentSpec], conf: JobConf,
                    role: str, ordinal: int, store=None,
                    seed: int = 0, device="cuda") -> dict:
    """One client party's walk of the component DAG.

    job_parameters.job_type selects train (default) or predict; predict
    loads the model from the model store ({"model": {"namespace",
    "version"?}}) and scores the DataIO tables locally (the reference's
    predict DSL flow, enter_point.py:218-260).  A train job with
    job_parameters.publish registers the guest's final model under that
    namespace (version = job id semantics are the caller's).
    """
    from flashe_tpu_torch.nn.evaluation import evaluate_classification
    from flashe_tpu_torch.nn.homo_nn import HomoNNGuest, HomoNNHost
    from flashe_tpu_torch.runtime.model_manager import default_model_manager

    jp = conf.job_parameters
    job_type = jp.get("job_type", "train")
    ctx: Dict[str, Any] = {}
    out: Dict[str, Any] = {"role": role, "ordinal": ordinal}
    for comp in components:
        if comp.module == "DataIO":
            data = _dataio(comp, conf, role, ordinal, store)
            for slot in comp.data_outputs or ["train"]:
                ctx[f"{comp.name}.{slot}"] = data
        elif comp.module in ("JZFHomoNN", "HomoNN"):
            ap = conf.component_param(comp.name, role, ordinal)
            param, create_label = translate_homo_nn(ap)
            refs = comp.data_inputs.get("train_data") or comp.data_inputs.get(
                "data", [])
            if not refs:
                raise ValueError(f"{comp.name}: no train_data input")
            x, y = ctx[refs[0]]
            if create_label:
                # next-token targets from the feature sequence itself
                # (jzf_nn_model.py:238-248): (n, T - 1) labels, which the
                # trainer's softmax cross-entropy takes position by position
                x = np.asarray(x)
                y = x[:, 1:].astype(np.int64)
                x = x[:, :-1]
            cls = HomoNNGuest if role == "guest" else HomoNNHost
            client = cls(param, seed=seed, device=device)
            if job_type == "predict":
                model_ref = jp.get("model") or {}
                if "namespace" not in model_ref:
                    raise ValueError(
                        "predict jobs need job_parameters.model.namespace")
                mm = default_model_manager()
                ns = model_ref["namespace"]
                ver = model_ref.get("version") or mm.latest_version(ns)
                client.load_model(mm.checkpoint_path(ns, ver), x[:1])
                scores = client.predict(x)
                out[comp.name] = {"model": {"namespace": ns,
                                            "version": ver},
                                  "aggregate_iter": client.aggregate_iter,
                                  "n": int(len(x))}
            elif param.cv.need_cv:
                # the reference ModelBase's cross-validation arm
                # (model_base.py:74-103): k federated fits, each fold in
                # its own federation scope
                from flashe_tpu_torch.nn.cross_validation import (
                    cv_fit_client,
                )

                if y is None:
                    raise ValueError(f"{comp.name}: cv needs labels")
                out[comp.name] = {
                    "cv": cv_fit_client(cls, param, trv, x, y, seed=seed,
                                        device=device)}
                continue
            else:
                if y is None:
                    raise ValueError(f"{comp.name}: training needs labels")
                client.fit(trv, x, y)
                scores = client.predict(x)
                out[comp.name] = {"history": client.history}
                if role == "guest" and jp.get("publish"):
                    out[comp.name]["published"] = default_model_manager(
                    ).save(jp["publish"], jp.get("model_version", "v1"),
                           client.trainer.params, client.aggregate_iter,
                           param_dict=param.to_dict(), quantizer_stats={})
            for slot in comp.data_outputs or ["train"]:
                ctx[f"{comp.name}.{slot}"] = (y, scores)
            out["_client"] = client
        elif comp.module == "Evaluation":
            refs = comp.data_inputs.get("data", [])
            if not refs:
                raise ValueError(f"{comp.name}: no data input")
            y, scores = ctx[refs[0]]
            if y is not None:
                out[comp.name] = evaluate_classification(y, scores)
    return out


def arbiter_pipeline(trv, components: List[ComponentSpec],
                     conf: JobConf, device="cuda") -> dict:
    """The arbiter only participates in training components (predict jobs
    run party-local, enter_point.py:218-260 — no aggregation)."""
    from flashe_tpu_torch.nn.homo_nn import HomoNNArbiter

    out: Dict[str, Any] = {"role": "arbiter"}
    if conf.job_parameters.get("job_type", "train") == "predict":
        return out
    for comp in components:
        if comp.module in ("JZFHomoNN", "HomoNN"):
            ap = conf.component_param(comp.name, "arbiter", 0)
            param, _ = translate_homo_nn(ap)
            if param.cv.need_cv:
                from flashe_tpu_torch.nn.cross_validation import (
                    cv_fit_arbiter,
                )

                out[comp.name] = cv_fit_arbiter(HomoNNArbiter, param, trv,
                                                device=device)
                continue
            arbiter = HomoNNArbiter(param, device=device)
            out[comp.name] = {"loss_history": arbiter.fit(trv)}
    return out


def run_dsl_job(dsl: dict, conf: dict, store=None, seed: int = 0,
                device="cuda") -> Dict[str, Any]:
    """Execute a DSL job in-process (one thread per role over the
    in-memory federation), every role on `device`.  Returns per-role
    component outputs."""
    from flashe_tpu_torch.device import resolve_device
    from flashe_tpu_torch.runtime.simulate import run_roles

    device = resolve_device(device)
    components = parse_dsl(dsl)
    jc = JobConf.parse(conf)

    def guest(trv):
        return client_pipeline(trv, components, jc, "guest", 0, store, seed,
                               device)

    def host(trv, hid):
        return client_pipeline(trv, components, jc, "host", hid, store,
                               seed + 1 + hid, device)

    def arbiter(trv):
        return arbiter_pipeline(trv, components, jc, device)

    results = run_roles(jc.n_hosts, guest, host, arbiter)
    for v in results.values():
        if isinstance(v, dict):
            v.pop("_client", None)  # not picklable / not part of the result
    return results
