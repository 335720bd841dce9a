# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: wire.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\nwire.proto\x12\x0cray_tpu.wire"\xcc\x01\n\x05Value\x12\x0e\n\x04null\x18\x01 \x01(\x08H\x00\x12\x0b\n\x01b\x18\x02 \x01(\x08H\x00\x12\x0b\n\x01i\x18\x03 \x01(\x10H\x00\x12\x0b\n\x01d\x18\x04 \x01(\x01H\x00\x12\x0b\n\x01s\x18\x05 \x01(\tH\x00\x12\x0e\n\x04data\x18\x06 \x01(\x0cH\x00\x12\'\n\x04list\x18\x07 \x01(\x0b2\x17.ray_tpu.wire.ListValueH\x00\x12+\n\x06struct\x18\x08 \x01(\x0b2\x19.ray_tpu.wire.StructValueH\x00\x12\x11\n\x07pickled\x18\t \x01(\x0cH\x00B\x06\n\x04kind"/\n\tListValue\x12"\n\x05items\x18\x01 \x03(\x0b2\x13.ray_tpu.wire.Value"\x88\x01\n\x0bStructValue\x125\n\x06fields\x18\x01 \x03(\x0b2%.ray_tpu.wire.StructValue.FieldsEntry\x1aB\n\x0bFieldsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12"\n\x05value\x18\x02 \x01(\x0b2\x13.ray_tpu.wire.Value:\x028\x01"\xcf\x01\n\x08Envelope\x12\x0f\n\x07version\x18\x01 \x01(\r\x12\x0c\n\x04type\x18\x02 \x01(\t\x12\x0b\n\x03rid\x18\x03 \x01(\x04\x12)\n\x06fields\x18\x04 \x01(\x0b2\x19.ray_tpu.wire.StructValue\x12\x0f\n\x07py_body\x18\x05 \x01(\x0c\x12\'\n\x05batch\x18\x06 \x01(\x0b2\x18.ray_tpu.wire.BatchFrame\x12\x10\n\x08trace_id\x18\x07 \x01(\x06\x12\x13\n\x0bparent_span\x18\x08 \x01(\x06\x12\x0b\n\x03raw\x18\t \x01(\x0c"4\n\nBatchFrame\x12&\n\x06frames\x18\x01 \x03(\x0b2\x16.ray_tpu.wire.Envelopeb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'wire_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _STRUCTVALUE_FIELDSENTRY._options = None
  _STRUCTVALUE_FIELDSENTRY._serialized_options = b'8\001'
  _VALUE._serialized_start=29
  _VALUE._serialized_end=233
  _LISTVALUE._serialized_start=235
  _LISTVALUE._serialized_end=282
  _STRUCTVALUE._serialized_start=285
  _STRUCTVALUE._serialized_end=421
  _STRUCTVALUE_FIELDSENTRY._serialized_start=355
  _STRUCTVALUE_FIELDSENTRY._serialized_end=421
  _ENVELOPE._serialized_start=424
  _ENVELOPE._serialized_end=631
  _BATCHFRAME._serialized_start=633
  _BATCHFRAME._serialized_end=685
# @@protoc_insertion_point(module_scope)
