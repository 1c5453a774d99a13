"""YAML workflow front-end.

Reference parity: ``broker-core/.../workflow/model/yaml/BpmnYamlParser.java``
and the Yaml* POJOs: a linear task list with optional per-task ``next``,
``end``, and exclusive-gateway ``switch`` cases, compiled onto the fluent
builder exactly as the reference does (split gateways get ids
``split-<task id>``).

Format:

    name: my-workflow
    tasks:
      - id: task1
        type: foo
        retries: 3
        headers: {k: v}
        inputs:  [{source: "$.a", target: "$.b"}]
        outputs: [{source: "$.c", target: "$.d"}]
        outputBehavior: MERGE
        switch:
          - case: $.orderValue >= 100
            goto: task2
          - default: task3
      - id: task2
        type: bar
        end: true
"""

from __future__ import annotations

from typing import Optional

import yaml

from zeebe_tpu_torch.models.bpmn.builder import Bpmn, ProcessBuilder
from zeebe_tpu_torch.models.bpmn.model import BpmnModel, OutputBehavior


def read_yaml_workflow(text: str) -> BpmnModel:
    definition = yaml.safe_load(text)
    if not isinstance(definition, dict):
        raise ValueError("YAML workflow must be a mapping")
    name = definition.get("name", "")
    tasks = definition.get("tasks", [])
    if not tasks:
        raise ValueError("YAML workflow needs at least one task")

    tasks_by_id = {t["id"]: t for t in tasks}
    created = set()
    builder = Bpmn.create_process(name).start_event()

    def add_task(b: ProcessBuilder, task_id: str) -> None:
        if task_id in created:
            b.connect_to(task_id)
            return
        task = tasks_by_id.get(task_id)
        if task is None:
            raise ValueError(f"No task with id: {task_id}")
        created.add(task_id)
        _add_service_task(b, task)
        _add_flow_from_task(b, task)

    def _add_service_task(b: ProcessBuilder, task: dict) -> None:
        behavior = OutputBehavior[str(task.get("outputBehavior", "MERGE")).upper()]
        b.service_task(
            task["id"],
            type=task.get("type", ""),
            retries=int(task.get("retries", 3)),
            headers=task.get("headers") or {},
            inputs=[(m["source"], m["target"]) for m in task.get("inputs") or []],
            outputs=[(m["source"], m["target"]) for m in task.get("outputs") or []],
            output_behavior=behavior,
        )

    def _add_flow_from_task(b: ProcessBuilder, task: dict) -> None:
        cases = task.get("switch") or task.get("cases") or []
        if cases:
            gateway_id = f"split-{task['id']}"
            b.exclusive_gateway(gateway_id)
            for case in cases:
                if "default" in case:
                    branch = b.branch(default=True)
                    add_task(branch, case["default"])
                else:
                    branch = b.branch(condition=case.get("case") or case.get("condition"))
                    add_task(branch, case.get("goto") or case.get("next"))
        elif task.get("next"):
            add_task(b, task["next"])
        else:
            next_task = _next_in_list(task)
            if not task.get("end", False) and next_task is not None:
                add_task(b, next_task["id"])
            else:
                b.end_event()

    def _next_in_list(task: dict) -> Optional[dict]:
        index = tasks.index(task)
        return tasks[index + 1] if index + 1 < len(tasks) else None

    add_task(builder, tasks[0]["id"])
    return builder.done()
