# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: gateway.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\rgateway.proto\x12\x10gateway_protocol\"\x14\n\x12HealthCheckRequest\"=\n\tPartition\x12\x14\n\x0cpartition_id\x18\x01 \x01(\x05\x12\x0c\n\x04host\x18\x02 \x01(\t\x12\x0c\n\x04port\x18\x03 \x01(\x05\"C\n\x13HealthCheckResponse\x12,\n\x07\x62rokers\x18\x01 \x03(\x0b\x32\x1b.gateway_protocol.Partition\"R\n\x12\x43reateTopicRequest\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x12\n\npartitions\x18\x02 \x01(\x05\x12\x1a\n\x12replication_factor\x18\x03 \x01(\x05\":\n\x13\x43reateTopicResponse\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x15\n\rpartition_ids\x18\x02 \x03(\x05\"@\n\x15\x44\x65ployWorkflowRequest\x12\x15\n\rresource_name\x18\x01 \x01(\t\x12\x10\n\x08resource\x18\x02 \x01(\x0c\"R\n\x10WorkflowMetadata\x12\x17\n\x0f\x62pmn_process_id\x18\x01 \x01(\t\x12\x0f\n\x07version\x18\x02 \x01(\x05\x12\x14\n\x0cworkflow_key\x18\x03 \x01(\x03\"\\\n\x16\x44\x65ployWorkflowResponse\x12\x0b\n\x03key\x18\x01 \x01(\x03\x12\x35\n\tworkflows\x18\x02 \x03(\x0b\x32\".gateway_protocol.WorkflowMetadata\"}\n\x1d\x43reateWorkflowInstanceRequest\x12\x17\n\x0f\x62pmn_process_id\x18\x01 \x01(\t\x12\x19\n\x0cpartition_id\x18\x02 \x01(\x05H\x00\x88\x01\x01\x12\x17\n\x0fpayload_msgpack\x18\x03 \x01(\x0c\x42\x0f\n\r_partition_id\"i\n\x1e\x43reateWorkflowInstanceResponse\x12\x1d\n\x15workflow_instance_key\x18\x01 \x01(\x03\x12\x17\n\x0f\x62pmn_process_id\x18\x02 \x01(\t\x12\x0f\n\x07version\x18\x03 \x01(\x05\"T\n\x1d\x43\x61ncelWorkflowInstanceRequest\x12\x14\n\x0cpartition_id\x18\x01 \x01(\x05\x12\x1d\n\x15workflow_instance_key\x18\x02 \x01(\x03\" \n\x1e\x43\x61ncelWorkflowInstanceResponse\"p\n\x15PublishMessageRequest\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x17\n\x0f\x63orrelation_key\x18\x02 \x01(\t\x12\x17\n\x0ftime_to_live_ms\x18\x03 \x01(\x03\x12\x17\n\x0fpayload_msgpack\x18\x04 \x01(\x0c\"\x18\n\x16PublishMessageResponse\"T\n\x12\x43ompleteJobRequest\x12\x14\n\x0cpartition_id\x18\x01 \x01(\x05\x12\x0f\n\x07job_key\x18\x02 \x01(\x03\x12\x17\n\x0fpayload_msgpack\x18\x03 \x01(\x0c\"\x15\n\x13\x43ompleteJobResponse\"H\n\x0e\x46\x61ilJobRequest\x12\x14\n\x0cpartition_id\x18\x01 \x01(\x05\x12\x0f\n\x07job_key\x18\x02 \x01(\x03\x12\x0f\n\x07retries\x18\x03 \x01(\x05\"\x11\n\x0f\x46\x61ilJobResponse\"Q\n\x17UpdateJobRetriesRequest\x12\x14\n\x0cpartition_id\x18\x01 \x01(\x05\x12\x0f\n\x07job_key\x18\x02 \x01(\x03\x12\x0f\n\x07retries\x18\x03 \x01(\x05\"\x1a\n\x18UpdateJobRetriesResponse\"Y\n\x13\x41\x63tivateJobsRequest\x12\x0c\n\x04type\x18\x01 \x01(\t\x12\x0e\n\x06worker\x18\x02 \x01(\t\x12\x10\n\x08max_jobs\x18\x03 \x01(\x05\x12\x12\n\ntimeout_ms\x18\x04 \x01(\x03\"\xf7\x01\n\x0c\x41\x63tivatedJob\x12\x14\n\x0cpartition_id\x18\x01 \x01(\x05\x12\x0b\n\x03key\x18\x02 \x01(\x03\x12\x0c\n\x04type\x18\x03 \x01(\t\x12\x0f\n\x07retries\x18\x04 \x01(\x05\x12\x10\n\x08\x64\x65\x61\x64line\x18\x05 \x01(\x03\x12\x0e\n\x06worker\x18\x06 \x01(\t\x12\x17\n\x0fpayload_msgpack\x18\x07 \x01(\x0c\x12\x17\n\x0f\x62pmn_process_id\x18\x08 \x01(\t\x12\x13\n\x0b\x61\x63tivity_id\x18\t \x01(\t\x12\x1d\n\x15workflow_instance_key\x18\n \x01(\x03\x12\x1d\n\x15\x61\x63tivity_instance_key\x18\x0b \x01(\x03\x32\xf5\x07\n\x07Gateway\x12Z\n\x0bHealthCheck\x12$.gateway_protocol.HealthCheckRequest\x1a%.gateway_protocol.HealthCheckResponse\x12Z\n\x0b\x43reateTopic\x12$.gateway_protocol.CreateTopicRequest\x1a%.gateway_protocol.CreateTopicResponse\x12\x63\n\x0e\x44\x65ployWorkflow\x12\'.gateway_protocol.DeployWorkflowRequest\x1a(.gateway_protocol.DeployWorkflowResponse\x12{\n\x16\x43reateWorkflowInstance\x12/.gateway_protocol.CreateWorkflowInstanceRequest\x1a\x30.gateway_protocol.CreateWorkflowInstanceResponse\x12{\n\x16\x43\x61ncelWorkflowInstance\x12/.gateway_protocol.CancelWorkflowInstanceRequest\x1a\x30.gateway_protocol.CancelWorkflowInstanceResponse\x12\x63\n\x0ePublishMessage\x12\'.gateway_protocol.PublishMessageRequest\x1a(.gateway_protocol.PublishMessageResponse\x12Z\n\x0b\x43ompleteJob\x12$.gateway_protocol.CompleteJobRequest\x1a%.gateway_protocol.CompleteJobResponse\x12N\n\x07\x46\x61ilJob\x12 .gateway_protocol.FailJobRequest\x1a!.gateway_protocol.FailJobResponse\x12i\n\x10UpdateJobRetries\x12).gateway_protocol.UpdateJobRetriesRequest\x1a*.gateway_protocol.UpdateJobRetriesResponse\x12W\n\x0c\x41\x63tivateJobs\x12%.gateway_protocol.ActivateJobsRequest\x1a\x1e.gateway_protocol.ActivatedJob0\x01\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'gateway_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _HEALTHCHECKREQUEST._serialized_start=35
  _HEALTHCHECKREQUEST._serialized_end=55
  _PARTITION._serialized_start=57
  _PARTITION._serialized_end=118
  _HEALTHCHECKRESPONSE._serialized_start=120
  _HEALTHCHECKRESPONSE._serialized_end=187
  _CREATETOPICREQUEST._serialized_start=189
  _CREATETOPICREQUEST._serialized_end=271
  _CREATETOPICRESPONSE._serialized_start=273
  _CREATETOPICRESPONSE._serialized_end=331
  _DEPLOYWORKFLOWREQUEST._serialized_start=333
  _DEPLOYWORKFLOWREQUEST._serialized_end=397
  _WORKFLOWMETADATA._serialized_start=399
  _WORKFLOWMETADATA._serialized_end=481
  _DEPLOYWORKFLOWRESPONSE._serialized_start=483
  _DEPLOYWORKFLOWRESPONSE._serialized_end=575
  _CREATEWORKFLOWINSTANCEREQUEST._serialized_start=577
  _CREATEWORKFLOWINSTANCEREQUEST._serialized_end=702
  _CREATEWORKFLOWINSTANCERESPONSE._serialized_start=704
  _CREATEWORKFLOWINSTANCERESPONSE._serialized_end=809
  _CANCELWORKFLOWINSTANCEREQUEST._serialized_start=811
  _CANCELWORKFLOWINSTANCEREQUEST._serialized_end=895
  _CANCELWORKFLOWINSTANCERESPONSE._serialized_start=897
  _CANCELWORKFLOWINSTANCERESPONSE._serialized_end=929
  _PUBLISHMESSAGEREQUEST._serialized_start=931
  _PUBLISHMESSAGEREQUEST._serialized_end=1043
  _PUBLISHMESSAGERESPONSE._serialized_start=1045
  _PUBLISHMESSAGERESPONSE._serialized_end=1069
  _COMPLETEJOBREQUEST._serialized_start=1071
  _COMPLETEJOBREQUEST._serialized_end=1155
  _COMPLETEJOBRESPONSE._serialized_start=1157
  _COMPLETEJOBRESPONSE._serialized_end=1178
  _FAILJOBREQUEST._serialized_start=1180
  _FAILJOBREQUEST._serialized_end=1252
  _FAILJOBRESPONSE._serialized_start=1254
  _FAILJOBRESPONSE._serialized_end=1271
  _UPDATEJOBRETRIESREQUEST._serialized_start=1273
  _UPDATEJOBRETRIESREQUEST._serialized_end=1354
  _UPDATEJOBRETRIESRESPONSE._serialized_start=1356
  _UPDATEJOBRETRIESRESPONSE._serialized_end=1382
  _ACTIVATEJOBSREQUEST._serialized_start=1384
  _ACTIVATEJOBSREQUEST._serialized_end=1473
  _ACTIVATEDJOB._serialized_start=1476
  _ACTIVATEDJOB._serialized_end=1723
  _GATEWAY._serialized_start=1726
  _GATEWAY._serialized_end=2739
# @@protoc_insertion_point(module_scope)
