"""BPMN 2.0 XML read/write.

Reference parity: ``bpmn-model/.../Bpmn.readModelFromStream`` (Bpmn.java:272)
and ``Bpmn.writeModelToStream``; Zeebe extension elements under the
``http://camunda.org/schema/zeebe/1.0`` namespace
(``ZeebeTaskDefinition``, ``ZeebeTaskHeaders``, ``ZeebeIoMapping``,
``ZeebeInput``/``ZeebeOutput``, ``ZeebeSubscription``).
"""

from __future__ import annotations

import io
import xml.etree.ElementTree as ET
from typing import Dict, Optional, Union

from zeebe_tpu_torch.models.bpmn.model import (
    BoundaryEvent,
    BpmnModel,
    EndEvent,
    ExclusiveGateway,
    FlowNode,
    IntermediateCatchEvent,
    Mapping,
    MessageDefinition,
    MultiInstanceLoopCharacteristics,
    OutputBehavior,
    ParallelGateway,
    Process,
    ReceiveTask,
    SequenceFlow,
    ServiceTask,
    StartEvent,
    SubProcess,
    TaskDefinition,
)

BPMN_NS = "http://www.omg.org/spec/BPMN/20100524/MODEL"
ZEEBE_NS = "http://camunda.org/schema/zeebe/1.0"

ET.register_namespace("bpmn", BPMN_NS)
ET.register_namespace("zeebe", ZEEBE_NS)


def _q(tag: str, ns: str = BPMN_NS) -> str:
    return f"{{{ns}}}{tag}"


class UnsupportedBpmnElement(ValueError):
    """A BPMN 2.0 construct outside the executable subset — deployment
    rejects with the element id and a reason (reference
    broker-core/.../workflow/model/validation/)."""


# executable subset (what _read_scope builds)
_SUPPORTED_TAGS = {
    "startEvent", "endEvent", "serviceTask", "exclusiveGateway",
    "parallelGateway", "intermediateCatchEvent", "receiveTask",
    "boundaryEvent", "subProcess", "sequenceFlow",
}

# legal non-executable content, safely skipped — including element
# SUB-structure the per-element readers consume via child.find() rather
# than the scope loop (multiInstanceLoopCharacteristics, incoming/outgoing
# references, event definitions)
_IGNORABLE_TAGS = {
    "extensionElements", "documentation", "ioSpecification", "laneSet",
    "textAnnotation", "association", "group", "category", "dataObject",
    "dataObjectReference", "dataStoreReference", "property",
    "BPMNDiagram", "BPMNPlane", "BPMNShape", "BPMNEdge",
    "multiInstanceLoopCharacteristics", "incoming", "outgoing",
    "messageEventDefinition", "timerEventDefinition",
    "conditionExpression",
}


def read_model(
    source: Union[str, bytes, io.IOBase], strict: bool = True
) -> BpmnModel:
    """Parse a BPMN XML document into a BpmnModel.

    ``strict`` (the deploy-time default) rejects elements outside the
    executable subset with :class:`UnsupportedBpmnElement`. Recovery
    paths (snapshot restore, workflow fetch) parse with ``strict=False``:
    those resources were already accepted by SOME deploy-time validator,
    and a version upgrade must never make a recorded deployment
    unrecoverable."""
    if isinstance(source, (str, bytes)):
        root = ET.fromstring(source)
    else:
        root = ET.parse(source).getroot()

    model = BpmnModel()

    # message definitions (global)
    messages_by_id: Dict[str, MessageDefinition] = {}
    for msg_el in root.findall(_q("message")):
        name = msg_el.get("name", "")
        correlation_key = ""
        sub = msg_el.find(f"{_q('extensionElements')}/{_q('subscription', ZEEBE_NS)}")
        if sub is not None:
            correlation_key = sub.get("correlationKey", "")
        msg = MessageDefinition(name=name, correlation_key=correlation_key)
        messages_by_id[msg_el.get("id", name)] = msg
        model.messages[name] = msg

    for process_el in root.findall(_q("process")):
        process = Process(
            id=process_el.get("id", "process"),
            name=process_el.get("name", ""),
            executable=process_el.get("isExecutable", "true") == "true",
        )
        model.add(process)
        # strict validation applies to EXECUTABLE processes only: a
        # collaboration's documentation-only pool (isExecutable="false")
        # never runs, so unsupported elements there must not reject the
        # deployment (reference validators scope to executable processes)
        _read_scope(
            model, process_el, process.id, messages_by_id,
            strict and process.executable,
        )

    return model


def _read_scope(model: BpmnModel, scope_el, scope_id: str, messages_by_id,
                strict: bool = True) -> None:
    flows = []
    for child in scope_el:
        tag = child.tag.rsplit("}", 1)[-1]
        el_id = child.get("id", "")
        if tag == "startEvent":
            node = StartEvent(id=el_id, name=child.get("name", ""))
        elif tag == "endEvent":
            node = EndEvent(id=el_id, name=child.get("name", ""))
        elif tag == "serviceTask":
            node = ServiceTask(id=el_id, name=child.get("name", ""))
            _read_task_extensions(child, node)
        elif tag == "exclusiveGateway":
            node = ExclusiveGateway(
                id=el_id, name=child.get("name", ""), default_flow_id=child.get("default")
            )
        elif tag == "parallelGateway":
            node = ParallelGateway(id=el_id, name=child.get("name", ""))
        elif tag == "intermediateCatchEvent":
            node = IntermediateCatchEvent(id=el_id, name=child.get("name", ""))
            msg_def = child.find(_q("messageEventDefinition"))
            if msg_def is not None:
                node.message = messages_by_id.get(msg_def.get("messageRef", ""))
            timer_def = child.find(_q("timerEventDefinition"))
            if timer_def is not None:
                dur = timer_def.find(_q("timeDuration"))
                if dur is not None and dur.text:
                    node.timer_duration_ms = _parse_iso_duration_ms(dur.text.strip())
        elif tag == "receiveTask":
            node = ReceiveTask(id=el_id, name=child.get("name", ""))
            node.message = messages_by_id.get(child.get("messageRef", ""))
        elif tag == "boundaryEvent":
            node = BoundaryEvent(
                id=el_id,
                name=child.get("name", ""),
                attached_to_id=child.get("attachedToRef", ""),
                cancel_activity=child.get("cancelActivity", "true") == "true",
            )
            msg_def = child.find(_q("messageEventDefinition"))
            if msg_def is not None:
                node.message = messages_by_id.get(msg_def.get("messageRef", ""))
            timer_def = child.find(_q("timerEventDefinition"))
            if timer_def is not None:
                dur = timer_def.find(_q("timeDuration"))
                if dur is not None and dur.text:
                    node.timer_duration_ms = _parse_iso_duration_ms(dur.text.strip())
        elif tag == "subProcess":
            node = SubProcess(id=el_id, name=child.get("name", ""))
            node.scope_id = scope_id
            mi_el = child.find(_q("multiInstanceLoopCharacteristics"))
            if mi_el is not None:
                node.multi_instance = _read_multi_instance(mi_el)
            model.add(node)
            _read_io_mappings(child, node)
            _read_scope(model, child, el_id, messages_by_id, strict)
            continue
        elif tag == "sequenceFlow":
            flow = SequenceFlow(
                id=el_id,
                source_id=child.get("sourceRef", ""),
                target_id=child.get("targetRef", ""),
                scope_id=scope_id,
            )
            cond = child.find(_q("conditionExpression"))
            if cond is not None and cond.text:
                flow.condition_expression = cond.text.strip()
            flows.append(flow)
            continue
        elif tag in _IGNORABLE_TAGS or not strict:
            continue  # non-executable content: docs, diagrams, extensions…
        else:
            # reference broker-core workflow/model/validation: a resource
            # the engine cannot execute REJECTS at deploy with the element
            # id and a reason — silently dropping an element would run a
            # different process than the one modeled
            raise UnsupportedBpmnElement(
                f"unsupported BPMN element <{tag}>"
                + (f" (id={el_id!r})" if el_id else "")
                + f" in scope {scope_id!r}; supported elements: "
                + ", ".join(sorted(_SUPPORTED_TAGS))
            )
        node.scope_id = scope_id
        if tag != "serviceTask":
            _read_io_mappings(child, node)
        model.add(node)

    for flow in flows:
        model.add(flow)
        model.connect(flow)


def _read_multi_instance(mi_el) -> MultiInstanceLoopCharacteristics:
    """<multiInstanceLoopCharacteristics> with the zeebe loop-definition
    extension (inputCollection/inputElement/outputCollection) or a
    <loopCardinality> child."""
    mi = MultiInstanceLoopCharacteristics()
    card = mi_el.find(_q("loopCardinality"))
    if card is not None and card.text:
        mi.cardinality = int(card.text.strip())
    ext = mi_el.find(_q("extensionElements"))
    if ext is not None:
        loop_def = ext.find(_q("loopCharacteristics", ZEEBE_NS))
        if loop_def is not None:
            mi.input_collection = loop_def.get("inputCollection", "")
            mi.input_element = loop_def.get("inputElement", "item") or "item"
            mi.output_collection = loop_def.get("outputCollection", "")
            mi.output_element = loop_def.get("outputElement", "")
    return mi


def _read_task_extensions(task_el, node: ServiceTask) -> None:
    ext = task_el.find(_q("extensionElements"))
    if ext is None:
        return
    task_def = ext.find(_q("taskDefinition", ZEEBE_NS))
    if task_def is not None:
        node.task_definition = TaskDefinition(
            type=task_def.get("type", ""),
            retries=int(task_def.get("retries", "3")),
        )
    headers = ext.find(_q("taskHeaders", ZEEBE_NS))
    if headers is not None:
        for h in headers.findall(_q("header", ZEEBE_NS)):
            node.task_headers[h.get("key", "")] = h.get("value", "")
    _read_io_mapping_ext(ext, node)


def _read_io_mappings(el, node: FlowNode) -> None:
    ext = el.find(_q("extensionElements"))
    if ext is not None:
        _read_io_mapping_ext(ext, node)


def _read_io_mapping_ext(ext, node: FlowNode) -> None:
    io_mapping = ext.find(_q("ioMapping", ZEEBE_NS))
    if io_mapping is None:
        return
    behavior = io_mapping.get("outputBehavior", "merge").upper()
    node.output_behavior = OutputBehavior[behavior]
    for inp in io_mapping.findall(_q("input", ZEEBE_NS)):
        node.input_mappings.append(Mapping(inp.get("source", "$"), inp.get("target", "$")))
    for out in io_mapping.findall(_q("output", ZEEBE_NS)):
        node.output_mappings.append(Mapping(out.get("source", "$"), out.get("target", "$")))


def _parse_iso_duration_ms(text: str) -> int:
    """PT5S / PT1M / PT0.5S style ISO-8601 durations (subset)."""
    if not text.startswith("PT"):
        raise ValueError(f"unsupported duration: {text}")
    total_ms = 0.0
    num = ""
    for ch in text[2:]:
        if ch.isdigit() or ch == ".":
            num += ch
        elif ch == "H":
            total_ms += float(num) * 3600_000
            num = ""
        elif ch == "M":
            total_ms += float(num) * 60_000
            num = ""
        elif ch == "S":
            total_ms += float(num) * 1000
            num = ""
        else:
            raise ValueError(f"unsupported duration: {text}")
    return int(total_ms)


def _format_iso_duration(ms: int) -> str:
    return f"PT{ms / 1000:g}S"


def write_model(model: BpmnModel) -> bytes:
    """Serialize a BpmnModel back to BPMN XML."""
    root = ET.Element(_q("definitions"))
    root.set("targetNamespace", "http://zeebe.io/bpmn")

    msg_ids = {}
    for i, (name, msg) in enumerate(sorted(model.messages.items())):
        msg_el = ET.SubElement(root, _q("message"))
        msg_id = f"message-{i}"
        msg_ids[name] = msg_id
        msg_el.set("id", msg_id)
        msg_el.set("name", name)
        if msg.correlation_key:
            ext = ET.SubElement(msg_el, _q("extensionElements"))
            sub = ET.SubElement(ext, _q("subscription", ZEEBE_NS))
            sub.set("correlationKey", msg.correlation_key)

    for process in model.processes:
        process_el = ET.SubElement(root, _q("process"))
        process_el.set("id", process.id)
        process_el.set("isExecutable", "true" if process.executable else "false")
        _write_scope(model, process_el, process.id, msg_ids)

    return ET.tostring(root, xml_declaration=True, encoding="utf-8")


def _write_scope(model: BpmnModel, scope_el, scope_id: str, msg_ids) -> None:
    for node in model.nodes_in_scope(scope_id):
        if isinstance(node, StartEvent):
            el = ET.SubElement(scope_el, _q("startEvent"))
        elif isinstance(node, EndEvent):
            el = ET.SubElement(scope_el, _q("endEvent"))
        elif isinstance(node, ServiceTask):
            el = ET.SubElement(scope_el, _q("serviceTask"))
            ext = ET.SubElement(el, _q("extensionElements"))
            td = ET.SubElement(ext, _q("taskDefinition", ZEEBE_NS))
            td.set("type", node.task_definition.type)
            td.set("retries", str(node.task_definition.retries))
            if node.task_headers:
                ths = ET.SubElement(ext, _q("taskHeaders", ZEEBE_NS))
                for k, v in node.task_headers.items():
                    h = ET.SubElement(ths, _q("header", ZEEBE_NS))
                    h.set("key", k)
                    h.set("value", v)
            _write_io_mapping(ext, node)
        elif isinstance(node, ExclusiveGateway):
            el = ET.SubElement(scope_el, _q("exclusiveGateway"))
            if node.default_flow_id:
                el.set("default", node.default_flow_id)
        elif isinstance(node, ParallelGateway):
            el = ET.SubElement(scope_el, _q("parallelGateway"))
        elif isinstance(node, IntermediateCatchEvent):
            el = ET.SubElement(scope_el, _q("intermediateCatchEvent"))
            if node.message is not None:
                md = ET.SubElement(el, _q("messageEventDefinition"))
                md.set("messageRef", msg_ids.get(node.message.name, ""))
            if node.timer_duration_ms is not None:
                td = ET.SubElement(el, _q("timerEventDefinition"))
                dur = ET.SubElement(td, _q("timeDuration"))
                dur.text = _format_iso_duration(node.timer_duration_ms)
        elif isinstance(node, ReceiveTask):
            el = ET.SubElement(scope_el, _q("receiveTask"))
            if node.message is not None:
                el.set("messageRef", msg_ids.get(node.message.name, ""))
        elif isinstance(node, BoundaryEvent):
            el = ET.SubElement(scope_el, _q("boundaryEvent"))
            el.set("attachedToRef", node.attached_to_id)
            el.set("cancelActivity", "true" if node.cancel_activity else "false")
            if node.message is not None:
                md = ET.SubElement(el, _q("messageEventDefinition"))
                md.set("messageRef", msg_ids.get(node.message.name, ""))
            if node.timer_duration_ms is not None:
                td = ET.SubElement(el, _q("timerEventDefinition"))
                dur = ET.SubElement(td, _q("timeDuration"))
                dur.text = _format_iso_duration(node.timer_duration_ms)
        elif isinstance(node, SubProcess):
            el = ET.SubElement(scope_el, _q("subProcess"))
            if node.multi_instance is not None:
                mi = node.multi_instance
                mi_el = ET.SubElement(el, _q("multiInstanceLoopCharacteristics"))
                if mi.cardinality is not None:
                    card = ET.SubElement(mi_el, _q("loopCardinality"))
                    card.text = str(mi.cardinality)
                if mi.input_collection or mi.output_collection:
                    ext = ET.SubElement(mi_el, _q("extensionElements"))
                    loop_def = ET.SubElement(ext, _q("loopCharacteristics", ZEEBE_NS))
                    if mi.input_collection:
                        loop_def.set("inputCollection", mi.input_collection)
                        loop_def.set("inputElement", mi.input_element)
                    if mi.output_collection:
                        loop_def.set("outputCollection", mi.output_collection)
                    if mi.output_element:
                        loop_def.set("outputElement", mi.output_element)
            _write_scope(model, el, node.id, msg_ids)
        else:
            continue
        el.set("id", node.id)
        if node.name:
            el.set("name", node.name)
        if not isinstance(node, ServiceTask) and (
            node.input_mappings or node.output_mappings
        ):
            ext = ET.SubElement(el, _q("extensionElements"))
            _write_io_mapping(ext, node)

    for flow in model.flows_in_scope(scope_id):
        el = ET.SubElement(scope_el, _q("sequenceFlow"))
        el.set("id", flow.id)
        el.set("sourceRef", flow.source_id)
        el.set("targetRef", flow.target_id)
        if flow.condition_expression:
            cond = ET.SubElement(el, _q("conditionExpression"))
            cond.text = flow.condition_expression


def _write_io_mapping(ext, node: FlowNode) -> None:
    if not node.input_mappings and not node.output_mappings and node.output_behavior == OutputBehavior.MERGE:
        return
    io_el = ET.SubElement(ext, _q("ioMapping", ZEEBE_NS))
    if node.output_behavior != OutputBehavior.MERGE:
        io_el.set("outputBehavior", node.output_behavior.name.lower())
    for m in node.input_mappings:
        inp = ET.SubElement(io_el, _q("input", ZEEBE_NS))
        inp.set("source", m.source)
        inp.set("target", m.target)
    for m in node.output_mappings:
        out = ET.SubElement(io_el, _q("output", ZEEBE_NS))
        out.set("source", m.source)
        out.set("target", m.target)
