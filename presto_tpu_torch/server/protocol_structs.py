"""Generated from protocol_vocab.json, beside this module, by the
reference's generator (scripts/gen_protocol.py), as the reference's
own protocol_structs.py is: do not edit by hand.

Validated envelope mirrors of the reference protocol structs
(presto_protocol_core.yml analog). from_dict() checks required
fields and primitive types, raising ProtocolUnsupported with the
struct + field named (the PlanChecker rejection contract)."""

from __future__ import annotations

import dataclasses
from typing import List, Optional

# one rejection type across the adapter + generated mirrors
from .protocol import ProtocolUnsupported  # noqa: E402


_PRIMS = {'str': str, 'int': int, 'float': (int, float),
          'bool': bool, 'dict': dict, 'list': list}


def _check(struct, name, kind, v):
    if v is None or kind not in _PRIMS:
        return v
    if kind in ('int', 'float') and isinstance(v, bool):
        raise ProtocolUnsupported(
            f'{struct}.{name}: expected {kind}, got bool')
    if not isinstance(v, _PRIMS[kind]):
        raise ProtocolUnsupported(
            f'{struct}.{name}: expected {kind}, got '
            f'{type(v).__name__}')
    return v


@dataclasses.dataclass
class TaskUpdateRequest:
    """presto-main-base/.../server/TaskUpdateRequest.java:50-55"""
    session: "SessionRepresentation" = None
    extraCredentials: dict = dataclasses.field(default_factory=lambda: {})
    fragment: object = None
    sources: List["TaskSource"] = dataclasses.field(default_factory=lambda: [])
    outputIds: "OutputBuffers" = None
    tableWriteInfo: dict = None

    @classmethod
    def from_dict(cls, j):
        if not isinstance(j, dict):
            raise ProtocolUnsupported(
                f'TaskUpdateRequest: expected object, got '
                f'{type(j).__name__}')
        if 'session' not in j:
            raise ProtocolUnsupported(
                'TaskUpdateRequest.session is required')
        return cls(
            session=None if j.get('session') is None else SessionRepresentation.from_dict(j.get('session')),
            extraCredentials=_check('TaskUpdateRequest', 'extraCredentials', 'dict', j.get('extraCredentials')),
            fragment=_check('TaskUpdateRequest', 'fragment', 'any', j.get('fragment')),
            sources=[TaskSource.from_dict(x) for x in (j.get('sources') or [])],
            outputIds=None if j.get('outputIds') is None else OutputBuffers.from_dict(j.get('outputIds')),
            tableWriteInfo=_check('TaskUpdateRequest', 'tableWriteInfo', 'dict', j.get('tableWriteInfo')),
        )

    def unknown_fields(self, j: dict):
        return sorted(set(j) - set(['extraCredentials', 'fragment', 'outputIds', 'session', 'sources', 'tableWriteInfo']))


@dataclasses.dataclass
class SessionRepresentation:
    """presto-main-base/.../SessionRepresentation.java"""
    queryId: str = None
    user: str = None
    catalog: str = None
    schema: str = None
    timeZoneKey: int = None
    systemProperties: dict = dataclasses.field(default_factory=lambda: {})
    catalogProperties: dict = dataclasses.field(default_factory=lambda: {})
    transactionId: str = None
    clientTags: list = dataclasses.field(default_factory=lambda: [])
    source: str = None
    startTime: int = None

    @classmethod
    def from_dict(cls, j):
        if not isinstance(j, dict):
            raise ProtocolUnsupported(
                f'SessionRepresentation: expected object, got '
                f'{type(j).__name__}')
        return cls(
            queryId=_check('SessionRepresentation', 'queryId', 'str', j.get('queryId')),
            user=_check('SessionRepresentation', 'user', 'str', j.get('user')),
            catalog=_check('SessionRepresentation', 'catalog', 'str', j.get('catalog')),
            schema=_check('SessionRepresentation', 'schema', 'str', j.get('schema')),
            timeZoneKey=_check('SessionRepresentation', 'timeZoneKey', 'int', j.get('timeZoneKey')),
            systemProperties=_check('SessionRepresentation', 'systemProperties', 'dict', j.get('systemProperties')),
            catalogProperties=_check('SessionRepresentation', 'catalogProperties', 'dict', j.get('catalogProperties')),
            transactionId=_check('SessionRepresentation', 'transactionId', 'str', j.get('transactionId')),
            clientTags=_check('SessionRepresentation', 'clientTags', 'list', j.get('clientTags')),
            source=_check('SessionRepresentation', 'source', 'str', j.get('source')),
            startTime=_check('SessionRepresentation', 'startTime', 'int', j.get('startTime')),
        )

    def unknown_fields(self, j: dict):
        return sorted(set(j) - set(['catalog', 'catalogProperties', 'clientTags', 'queryId', 'schema', 'source', 'startTime', 'systemProperties', 'timeZoneKey', 'transactionId', 'user']))


@dataclasses.dataclass
class TaskSource:
    """presto-main-base/.../execution/TaskSource.java"""
    planNodeId: str = None
    splits: List["ScheduledSplit"] = dataclasses.field(default_factory=lambda: [])
    noMoreSplits: bool = False
    noMoreSplitsForLifespan: list = dataclasses.field(default_factory=lambda: [])

    @classmethod
    def from_dict(cls, j):
        if not isinstance(j, dict):
            raise ProtocolUnsupported(
                f'TaskSource: expected object, got '
                f'{type(j).__name__}')
        return cls(
            planNodeId=_check('TaskSource', 'planNodeId', 'str', j.get('planNodeId')),
            splits=[ScheduledSplit.from_dict(x) for x in (j.get('splits') or [])],
            noMoreSplits=_check('TaskSource', 'noMoreSplits', 'bool', j.get('noMoreSplits')),
            noMoreSplitsForLifespan=_check('TaskSource', 'noMoreSplitsForLifespan', 'list', j.get('noMoreSplitsForLifespan')),
        )

    def unknown_fields(self, j: dict):
        return sorted(set(j) - set(['noMoreSplits', 'noMoreSplitsForLifespan', 'planNodeId', 'splits']))


@dataclasses.dataclass
class ScheduledSplit:
    """presto-main-base/.../execution/ScheduledSplit.java"""
    sequenceId: int = None
    planNodeId: str = None
    split: "Split" = None

    @classmethod
    def from_dict(cls, j):
        if not isinstance(j, dict):
            raise ProtocolUnsupported(
                f'ScheduledSplit: expected object, got '
                f'{type(j).__name__}')
        return cls(
            sequenceId=_check('ScheduledSplit', 'sequenceId', 'int', j.get('sequenceId')),
            planNodeId=_check('ScheduledSplit', 'planNodeId', 'str', j.get('planNodeId')),
            split=None if j.get('split') is None else Split.from_dict(j.get('split')),
        )

    def unknown_fields(self, j: dict):
        return sorted(set(j) - set(['planNodeId', 'sequenceId', 'split']))


@dataclasses.dataclass
class Split:
    """presto-main-base/.../metadata/Split.java"""
    connectorId: object = None
    transactionHandle: object = None
    connectorSplit: object = None
    lifespan: object = None
    splitContext: object = None

    @classmethod
    def from_dict(cls, j):
        if not isinstance(j, dict):
            raise ProtocolUnsupported(
                f'Split: expected object, got '
                f'{type(j).__name__}')
        return cls(
            connectorId=_check('Split', 'connectorId', 'any', j.get('connectorId')),
            transactionHandle=_check('Split', 'transactionHandle', 'any', j.get('transactionHandle')),
            connectorSplit=_check('Split', 'connectorSplit', 'any', j.get('connectorSplit')),
            lifespan=_check('Split', 'lifespan', 'any', j.get('lifespan')),
            splitContext=_check('Split', 'splitContext', 'any', j.get('splitContext')),
        )

    def unknown_fields(self, j: dict):
        return sorted(set(j) - set(['connectorId', 'connectorSplit', 'lifespan', 'splitContext', 'transactionHandle']))


@dataclasses.dataclass
class OutputBuffers:
    """presto-main-base/.../execution/buffer/OutputBuffers.java"""
    type: str = None
    version: int = 0
    noMoreBufferIds: bool = False
    buffers: dict = dataclasses.field(default_factory=lambda: {})

    @classmethod
    def from_dict(cls, j):
        if not isinstance(j, dict):
            raise ProtocolUnsupported(
                f'OutputBuffers: expected object, got '
                f'{type(j).__name__}')
        return cls(
            type=_check('OutputBuffers', 'type', 'str', j.get('type')),
            version=_check('OutputBuffers', 'version', 'int', j.get('version')),
            noMoreBufferIds=_check('OutputBuffers', 'noMoreBufferIds', 'bool', j.get('noMoreBufferIds')),
            buffers=_check('OutputBuffers', 'buffers', 'dict', j.get('buffers')),
        )

    def unknown_fields(self, j: dict):
        return sorted(set(j) - set(['buffers', 'noMoreBufferIds', 'type', 'version']))


@dataclasses.dataclass
class PlanFragment:
    """presto-main-base/.../sql/planner/PlanFragment.java:50"""
    id: object = None
    root: object = None
    variables: list = dataclasses.field(default_factory=lambda: [])
    partitioning: object = None
    tableScanSchedulingOrder: list = dataclasses.field(default_factory=lambda: [])
    partitioningScheme: "PartitioningScheme" = None
    stageExecutionDescriptor: dict = None
    outputTableWriterFragment: bool = False
    jsonRepresentation: str = None

    @classmethod
    def from_dict(cls, j):
        if not isinstance(j, dict):
            raise ProtocolUnsupported(
                f'PlanFragment: expected object, got '
                f'{type(j).__name__}')
        if 'root' not in j:
            raise ProtocolUnsupported(
                'PlanFragment.root is required')
        return cls(
            id=_check('PlanFragment', 'id', 'any', j.get('id')),
            root=_check('PlanFragment', 'root', 'any', j.get('root')),
            variables=_check('PlanFragment', 'variables', 'list', j.get('variables')),
            partitioning=_check('PlanFragment', 'partitioning', 'any', j.get('partitioning')),
            tableScanSchedulingOrder=_check('PlanFragment', 'tableScanSchedulingOrder', 'list', j.get('tableScanSchedulingOrder')),
            partitioningScheme=None if j.get('partitioningScheme') is None else PartitioningScheme.from_dict(j.get('partitioningScheme')),
            stageExecutionDescriptor=_check('PlanFragment', 'stageExecutionDescriptor', 'dict', j.get('stageExecutionDescriptor')),
            outputTableWriterFragment=_check('PlanFragment', 'outputTableWriterFragment', 'bool', j.get('outputTableWriterFragment')),
            jsonRepresentation=_check('PlanFragment', 'jsonRepresentation', 'str', j.get('jsonRepresentation')),
        )

    def unknown_fields(self, j: dict):
        return sorted(set(j) - set(['id', 'jsonRepresentation', 'outputTableWriterFragment', 'partitioning', 'partitioningScheme', 'root', 'stageExecutionDescriptor', 'tableScanSchedulingOrder', 'variables']))


@dataclasses.dataclass
class PartitioningScheme:
    """presto-spi/.../spi/plan/PartitioningScheme.java"""
    partitioning: object = None
    outputLayout: list = dataclasses.field(default_factory=lambda: [])
    hashColumn: object = None
    replicateNullsAndAny: bool = False
    bucketToPartition: object = None

    @classmethod
    def from_dict(cls, j):
        if not isinstance(j, dict):
            raise ProtocolUnsupported(
                f'PartitioningScheme: expected object, got '
                f'{type(j).__name__}')
        return cls(
            partitioning=_check('PartitioningScheme', 'partitioning', 'any', j.get('partitioning')),
            outputLayout=_check('PartitioningScheme', 'outputLayout', 'list', j.get('outputLayout')),
            hashColumn=_check('PartitioningScheme', 'hashColumn', 'any', j.get('hashColumn')),
            replicateNullsAndAny=_check('PartitioningScheme', 'replicateNullsAndAny', 'bool', j.get('replicateNullsAndAny')),
            bucketToPartition=_check('PartitioningScheme', 'bucketToPartition', 'any', j.get('bucketToPartition')),
        )

    def unknown_fields(self, j: dict):
        return sorted(set(j) - set(['bucketToPartition', 'hashColumn', 'outputLayout', 'partitioning', 'replicateNullsAndAny']))


ALL_STRUCTS = ['TaskUpdateRequest', 'SessionRepresentation', 'TaskSource', 'ScheduledSplit', 'Split', 'OutputBuffers', 'PlanFragment', 'PartitioningScheme']
